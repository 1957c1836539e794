"""Models: the Llama-family decoder, its named configs, and the weight
bridge from the JAX package's parameter tree."""
