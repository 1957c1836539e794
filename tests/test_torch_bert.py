"""gofr_tpu_torch's encoder and MLP families against gofr_tpu on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its port, the weights initialised in JAX and carried over by
``models/convert.py``:
- ``layer_norm`` (f32 2e-5, bf16 2e-2);
- ``bert_embed`` at bert-tiny's configuration and at a 2-layer variant
  with four heads of D = 64, in f32 (2e-5) and bf16 (2e-2), over random
  prefix masks with a length-1 row and a padded row (the runner's: one
  valid token of id 0); the tokens past each row's length do not move it;
- int8, int4 and w8a8 BERT against JAX's ``quantize_params`` tree (the
  packs bit for bit; the embeddings at ``test_torch_quant.py``'s
  tolerances), and the quantized keys exactly JAX's;
- the tanh GELU (JAX's default; torch's default is the erf form);
- ``mlp_forward`` and ``init_mlp``'s shapes and scale;
- the weight bridges' round trips; a mask that is not a prefix raises.
Attention on the CPU is the flash kernel's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import bert as jbert
from gofr_tpu.models import mlp as jmlp
from gofr_tpu.models import quant as jq
from gofr_tpu.ops.norms import layer_norm as jax_layer_norm
from gofr_tpu.tpu.flops import bert_param_count as jax_bert_param_count
from gofr_tpu_torch.models import bert
from gofr_tpu_torch.models import quant
from gofr_tpu_torch.models.convert import (
    bert_from_tree,
    mlp_from_tree,
    to_torch,
    tree_from_bert,
    tree_from_mlp,
)
from gofr_tpu_torch.models.mlp import MLP, MLPConfig, init_mlp, mlp_forward
from gofr_tpu_torch.ops.norms import layer_norm
from gofr_tpu_torch.tpu.flops import bert_param_count

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bert-tiny's serving configuration, and a 2-layer variant with more D = 64 heads
SHAPES = {
    "bert-tiny": dict(vocab_size=30522, dim=128, n_layers=2, n_heads=2, hidden_dim=512,
                      max_seq=128),
    "4 heads of 64": dict(vocab_size=500, dim=256, n_layers=2, n_heads=4, hidden_dim=384,
                          max_seq=64),
}
QUANT_TOL = {"int8": 1e-4, "int4": 1e-4, "w8a8": 2e-3}  # test_torch_quant.py's, f32


def _configs(shape: str, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return (jbert.BertConfig(**SHAPES[shape], dtype=jdt),
            bert.BertConfig(**SHAPES[shape], dtype=tdt))


def _jax_tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def _inputs(cfg, b: int = 4, seed: int = 0):
    """[B, S=max_seq] ids and a prefix mask: a random length in each row,
    row 1 of length 1, the last row padded as the runner pads (one valid
    token of id 0)."""
    rng = np.random.default_rng(seed)
    s = cfg.max_seq
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = rng.integers(2, s + 1, b)
    lens[1] = 1
    lens[-1] = 1
    tokens[-1] = 0
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return tokens, mask


def _jax_embed(params, cfg, tokens, mask):
    out = jbert.bert_embed(params, jnp.asarray(tokens), jnp.asarray(mask), cfg)
    return np.asarray(out.astype(jnp.float32))


def _port_embed(model, tokens, mask):
    return bert.bert_embed(model, torch.from_numpy(tokens), torch.from_numpy(mask)).numpy()


@pytest.fixture(scope="module")
def pairs():
    """(JAX config, JAX params, port config, port model) by (shape, dtype)."""
    out = {}
    for shape in SHAPES:
        for dtype in DTYPES:
            jcfg, tcfg = _configs(shape, dtype)
            params = jbert.init_bert(jax.random.key(3), jcfg)
            out[shape, dtype] = (jcfg, params, tcfg, bert_from_tree(_jax_tree(params), tcfg, "cpu"))
    return out


# -- layer_norm ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 7, 128), (2, 768)])
def test_layer_norm_matches_jax(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jax_layer_norm(*(jnp.asarray(a, jdt) for a in (x, w, b)), 1e-12)
    got = layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, w, b)), 1e-12)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


# -- bert_embed --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_bert_embed_matches_jax(pairs, shape, dtype):
    jcfg, params, _, model = pairs[shape, dtype]
    tokens, mask = _inputs(jcfg)
    want = _jax_embed(params, jcfg, tokens, mask)
    got = _port_embed(model, tokens, mask)
    assert got.shape == (tokens.shape[0], jcfg.dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_padding_content_does_not_move_an_embedding(pairs, dtype):
    jcfg, _, _, model = pairs["bert-tiny", dtype]
    tokens, mask = _inputs(jcfg, seed=5)
    other = tokens.copy()
    pad = mask == 0
    other[pad] = np.random.default_rng(9).integers(0, jcfg.vocab_size, int(pad.sum()))
    assert (other != tokens).any()
    np.testing.assert_array_equal(_port_embed(model, other, mask), _port_embed(model, tokens, mask))


def test_a_mask_that_is_not_a_prefix_raises(pairs):
    jcfg, _, _, model = pairs["4 heads of 64", "float32"]
    tokens, mask = _inputs(jcfg)
    mask[0, 0] = 0  # a hole before valid tokens
    with pytest.raises(ValueError, match="prefix"):
        _port_embed(model, tokens, mask)


def test_gelu_is_the_tanh_form(pairs, monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh form, torch's ``F.gelu`` to the
    erf form, and the two part by more than 1e-4 over [-6, 6];
    ``bert_embed`` calls the tanh form in every layer."""
    x = torch.linspace(-6, 6, 1201)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    gelu = torch.nn.functional.gelu
    np.testing.assert_allclose(gelu(x, approximate="tanh").numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(gelu(x).numpy() - want).max() > 1e-4
    forms = []

    def recording(t, approximate="none"):
        forms.append(approximate)
        return gelu(t, approximate=approximate)

    monkeypatch.setattr(bert.F, "gelu", recording)
    jcfg, _, _, model = pairs["4 heads of 64", "float32"]
    _port_embed(model, *_inputs(jcfg))
    assert forms == ["tanh"] * jcfg.n_layers


# -- quantized BERT ----------------------------------------------------------------------

def _pack_np(pack: dict) -> dict:
    return {k: (quant.unpack_int4(v) if k == "q4" else v).numpy() for k, v in pack.items()}


@pytest.mark.parametrize("mode", ("int8", "int4", "w8a8"))
def test_quantized_bert_matches_jax(pairs, mode):
    jcfg, params, tcfg, dense = pairs["4 heads of 64", "float32"]
    qparams = jq.quantize_params(params, mode)
    tokens, mask = _inputs(jcfg, seed=2)
    want = _jax_embed(qparams, jcfg, tokens, mask)
    model = bert_from_tree(_jax_tree(qparams), tcfg, "cpu")
    assert model.quant == mode
    np.testing.assert_allclose(_port_embed(model, tokens, mask), want, rtol=QUANT_TOL[mode],
                               atol=QUANT_TOL[mode])
    # the port's own quantization of the dense model gives JAX's packs
    mine = dense.quantized(mode)
    for i, layer in enumerate(mine.layers):
        for key in bert.LAYER_MATMULS:
            got = _pack_np(getattr(layer, key).pack)
            for k, v in qparams["layers"][key].items():
                np.testing.assert_array_equal(got[k], np.asarray(v[i]).astype(got[k].dtype),
                                              err_msg=f"{key}.{k}")
    # tests/test_models.py's bound of a quantized BERT against its dense one
    assert np.abs(_port_embed(mine, tokens, mask) - _port_embed(dense, tokens, mask)).max() < 0.05


@pytest.mark.parametrize("mode", ("int8", "int4", "w8a8"))
def test_quantize_params_takes_exactly_jax_keys_on_a_bert_tree(pairs, mode):
    _, params, _, model = pairs["4 heads of 64", "float32"]
    torch_tree = jax.tree.map(to_torch, _jax_tree(params))

    def packed(tree, prefix=""):
        out = set()
        for k, v in tree.items():
            if isinstance(v, dict) and set(v) & {"q", "q4", "q8"}:
                out.add(prefix + k)
            elif isinstance(v, dict):
                out |= packed(v, prefix + k + ".")
        return out

    want = packed(jq.quantize_params(params, mode))
    assert want == {f"layers.{k}" for k in ("wqkv", "wo", "w_in", "w_out")}
    assert packed(quant.quantize_params(torch_tree, mode)) == want
    assert packed(tree_from_bert(quant.quantize_params(model, mode))) == want


def test_quantized_init_equals_quantize_after():
    cfg = bert.BertConfig(**SHAPES["4 heads of 64"])
    dense = bert.Bert.random(cfg, "cpu", seed=4)
    drawn = bert.Bert.random(cfg, "cpu", seed=4, quant="int8")
    for a, b in zip(drawn.state_dict().values(), dense.quantized("int8").state_dict().values()):
        assert torch.equal(a, b)
    assert drawn.weight_bytes() < dense.weight_bytes()


# -- the MLP -------------------------------------------------------------------------------

def test_mlp_forward_matches_jax():
    jcfg = jmlp.MLPConfig()
    params = jmlp.init_mlp(jax.random.key(5), jcfg)
    model = mlp_from_tree(_jax_tree(params), MLPConfig(), "cpu")
    x = np.random.default_rng(3).standard_normal((8, jcfg.in_dim)).astype(np.float32)
    want = np.asarray(jmlp.mlp_forward(params, jnp.asarray(x)))
    got = mlp_forward(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL["float32"], atol=TOL["float32"])


def test_init_mlp_draws_he_scaled_weights_from_the_generator():
    cfg = MLPConfig()
    gen = torch.Generator().manual_seed(0)
    a = init_mlp(cfg, gen, "cpu")
    b = init_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    jtree = _jax_tree(jmlp.init_mlp(jax.random.key(0), jmlp.MLPConfig()))
    for name, t in tree_from_mlp(a).items():
        assert t.shape == jtree[name].shape and t.dtype == jtree[name].dtype
        assert torch.equal(getattr(a, name), getattr(b, name))
    for name, fan_in in (("w1", cfg.in_dim), ("w2", cfg.hidden_dim)):
        assert abs(float(getattr(a, name).std()) / (2.0 / fan_in) ** 0.5 - 1) < 0.1
    assert not a.b1.any() and not a.b2.any()


# -- the weight bridges and the init ---------------------------------------------------------

@pytest.mark.parametrize("mode", ("", "int8", "int4", "w8a8"))
def test_bert_tree_round_trips(pairs, mode):
    _, params, tcfg, _ = pairs["bert-tiny", "bfloat16"]
    tree = _jax_tree(jq.quantize_params(params, mode) if mode else params)
    back = tree_from_bert(bert_from_tree(tree, tcfg, "cpu"))
    flat_want, flat_got = (jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves_with_path(back))
    assert [p for p, _ in flat_want] == [p for p, _ in flat_got]
    for (path, want), (_, got) in zip(flat_want, flat_got):
        want = want.astype(np.int8) if want.dtype.name == "int4" else want.astype(got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))


def test_mlp_tree_round_trips():
    tree = _jax_tree(jmlp.init_mlp(jax.random.key(1), jmlp.MLPConfig()))
    back = tree_from_mlp(mlp_from_tree(tree, MLPConfig(), "cpu"))
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    assert isinstance(mlp_from_tree(tree, MLPConfig(), "cpu"), MLP)


@pytest.mark.parametrize("shape", SHAPES)
def test_init_bert_has_jax_shapes_scale_and_count(shape):
    jcfg, tcfg = _configs(shape, "float32")
    want = _jax_tree(jbert.init_bert(jax.random.key(0), jcfg))
    model = bert.Bert.random(tcfg, "cpu", seed=0)
    got = tree_from_bert(model)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
    for name, fan_in in (("tok_embed", tcfg.dim), ("pos_embed", tcfg.dim)):
        assert abs(float(getattr(model, name).std()) * fan_in ** 0.5 - 0.986) < 0.05
    w_out = got["layers"]["w_out"]
    assert abs(float(w_out.std()) * tcfg.hidden_dim ** 0.5 - 0.986) < 0.05
    assert np.abs(w_out).max() <= 3 * tcfg.hidden_dim ** -0.5 + 1e-6
    n = sum(p.numel() for p in model.parameters())
    assert n == bert_param_count(tcfg) == jax_bert_param_count(jcfg)
