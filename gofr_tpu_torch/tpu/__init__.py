"""The inference device (``device.py``) and its prefill batcher
(``batcher.py``); the module path is the JAX package's."""
