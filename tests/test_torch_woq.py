"""Weight-only quantisation of the PyTorch port against the JAX package.

``quantize_params`` (``inference/woq.py``) on the tiny model's weights
(``CausalLM.init``, carried across with ``params_from_numpy``) quantises the
same leaves as JAX's, for int8, fp8 and int4, with codes and scales equal
(int8 codes by the tie rule of ``test_torch_quant.py``); the byte estimate
equals JAX's and the real bytes; stacked ``[L, ...]`` leaves are quantised
per layer; offload raises ``NotImplementedError``.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import woq as jax_woq
from deepspeed_tpu_torch.inference import woq
from deepspeed_tpu_torch.inference.config import QuantConfig
from deepspeed_tpu_torch.models.transformer import layer_slice
from deepspeed_tpu_torch.ops.quant import quantize_int8

from .test_torch_engine_v2 import make_model
from .test_torch_quant import assert_codes_tie_rule


@pytest.fixture(scope="module")
def model():
    return make_model()


def _jax_leaves(tree):
    is_woq = lambda x: isinstance(x, jax_woq.WOQTensor)  # noqa: E731
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_woq)[0]
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


@pytest.mark.parametrize("fmt", ["int8", "fp8", "int4"])
def test_quantize_params_matches_jax(model, fmt):
    _, jparams, _, params = model
    jquant = jax_woq.quantize_params(jparams, fmt, min_size=0)
    quant = woq.quantize_params(params, fmt, min_size=0)
    want, got = _jax_leaves(jquant), dict(woq._leaves(quant))
    assert set(got) == set(want)
    dense = dict(woq._leaves(woq.dequantize_params(quant, torch.float32)))
    for key, w in _jax_leaves(jax_woq.dequantize_params(jquant, jax.numpy.float32)).items():
        np.testing.assert_array_equal(dense[key].numpy(), np.asarray(w))
    n_quantised = 0
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, woq.WOQTensor) == isinstance(w, jax_woq.WOQTensor), key
        if not isinstance(w, jax_woq.WOQTensor):
            continue
        n_quantised += 1
        assert (g.fmt, g.shape, g.stacked) == (w.fmt, tuple(w.shape), w.stacked), key
        assert tuple(g.q.shape) == w.q.shape and tuple(g.scale.shape) == w.scale.shape, key
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        if fmt == "int8":
            assert_codes_tie_rule(g.q.numpy(), w.q)
        else:
            np.testing.assert_array_equal(g.q.view(torch.uint8).numpy(),
                                          np.asarray(w.q).view(np.uint8))
        np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                      np.asarray(w.astype(jax.numpy.float32)))
    # wq wk wv wo w_gate w_up w_down and lm_head, whose odd vocab (97) int4 leaves dense
    assert n_quantised == (7 if fmt == "int4" else 8)


def test_tensor_classes_select(model):
    _, _, _, params = model
    q = woq.quantize_params(params, "int8", min_size=0, classes=["attn"])
    assert isinstance(q["layers"]["attn"]["wq"]["kernel"], woq.WOQTensor)
    assert not isinstance(q["layers"]["mlp"]["w_up"]["kernel"], woq.WOQTensor)
    q2 = woq.quantize_params(params, "int8", min_size=0, classes=["mlp"])
    assert isinstance(q2["layers"]["mlp"]["w_up"]["kernel"], woq.WOQTensor)
    assert not isinstance(q2["layers"]["attn"]["wq"]["kernel"], woq.WOQTensor)
    assert not isinstance(q2["lm_head"]["kernel"], woq.WOQTensor)
    with pytest.raises(ValueError, match="unknown WOQ tensor class"):
        woq.quantize_params(params, "int8", min_size=0, classes=["bogus"])


@pytest.mark.parametrize("fmt", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("min_size", [0, 2048])
def test_bytes_estimate_matches_jax_and_real(model, fmt, min_size):
    _, jparams, _, params = model
    est = woq.quantized_bytes_estimate(params, fmt, min_size=min_size, dense_itemsize=4)
    assert est == jax_woq.quantized_bytes_estimate(jparams, fmt, min_size=min_size,
                                                   dense_itemsize=4)
    assert est == woq.woq_bytes(woq.quantize_params(params, fmt, min_size=min_size))
    assert woq.woq_bytes(params) == sum(x.size * x.dtype.itemsize
                                        for x in jax.tree_util.tree_leaves(jparams))


@pytest.mark.parametrize("shape", [(3, 64, 64), (3, 50, 90), (2, 10, 6)])
def test_stacked_leaves_quantise_per_layer(shape):
    """Blocks never cross a layer: each layer slice is its own quantiser
    call, whether its size is a multiple of the block (4096, or 60 < 2048)
    or not (4500)."""
    x = torch.randn(shape)
    leaf = woq._quantize_leaf(x, "int8", stacked=True)
    assert leaf.stacked and leaf.shape == shape
    for i in range(shape[0]):
        q, s = quantize_int8(x[i])
        assert torch.equal(leaf.q[i], q) and torch.equal(leaf.scale[i], s)
        torch.testing.assert_close(leaf[i].to(torch.float32), layer_slice({"w": leaf}, i)["w"]
                                   .to(torch.float32), rtol=0, atol=0)
    assert leaf.to(torch.float32).shape == shape


def test_offload_and_config_raise(model):
    _, _, _, params = model
    with pytest.raises(NotImplementedError):
        woq.offload_params(params)
    with pytest.raises(NotImplementedError):
        woq.OffloadedTensor(params["lm_head"]["kernel"])
    with pytest.raises(NotImplementedError):
        woq.WOQTensor(torch.zeros(4, dtype=torch.int8), torch.ones(1), "int8", (2, 2),
                      dev_sharding=object())
    assert woq.woq_format(QuantConfig(bits=4)) == "int4"
    assert woq.woq_format(QuantConfig(qtype="fp")) == "fp8"
    with pytest.raises(ValueError):
        woq.woq_format(QuantConfig(bits=3))
    with pytest.raises(ValueError, match="unknown config key"):
        QuantConfig.from_dict({"enabled": True, "offload": True})
    assert QuantConfig.from_dict({"group_size": 64}).group_size == 64
