"""The port's int4 path (ops/quant, ops/cuda/quant_matmul's plain version,
utils/quant_convert, params_to_torch) against the JAX package on the CPU.

Inputs come from numpy seeds and reach both sides as numpy arrays.
Tolerances: the layout conversions are bit-exact; the plain w4a16_matmul
agrees with the XLA dequant path of ``int4_linear`` to 1e-4 (both fp32, only
the order of sums differs) and with the Pallas kernel in interpret mode to
1e-2 (the packed kernel rounds x to bf16, quant_matmul.py:195-196).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zhilight_tpu.ops import quant as JQ
from zhilight_tpu.ops.pallas import quant_matmul as JQM
from zhilight_tpu.utils import hf_loader as JH
from zhilight_tpu.utils import quant_convert as JC
from zhilight_tpu_torch.ops import quant as TQ
from zhilight_tpu_torch.ops.cuda import quant_matmul as TQM
from zhilight_tpu_torch.ops.linear import linear
from zhilight_tpu_torch.utils import hf_loader as TH
from zhilight_tpu_torch.utils import quant_convert as TC
from zhilight_tpu_torch.utils.convert import params_to_torch


def make_int4(K, N, G, seed):
    """tests/test_quant.py's make_int4."""
    rng = np.random.RandomState(seed)
    w_p = rng.randint(0, 16, size=(K, N)).astype(np.int8)
    scales = (rng.rand(G, N).astype(np.float32) + 0.5) * 0.01
    zeros = rng.randint(1, 16, size=(G, N)).astype(np.float32)
    return w_p, scales, zeros


def _kernel_inputs(seed):
    """tests/test_quant.py:155-186's inputs: K 512, N 256, gs 128, M 16."""
    rng = np.random.RandomState(seed)
    K, N, gs = 512, 256, 128
    w_p = rng.randint(0, 16, size=(K, N)).astype(np.int8)
    scales = ((rng.rand(K // gs, N) + 0.5) * 0.01).astype(np.float32)
    zeros = rng.randint(1, 16, size=(K // gs, N)).astype(np.float32)
    x = rng.randn(16, K).astype(np.float32)
    return x, w_p, scales, zeros


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("packed", [False, True])
def test_plain_w4a16_matches_pallas_interpret(packed):
    x, w_p, scales, zeros = _kernel_inputs(7 if packed else 6)
    jw = JQ.pack_int4(jnp.asarray(w_p)) if packed else jnp.asarray(w_p)
    want = np.asarray(JQM.w4a16_matmul(jnp.asarray(x), jw, jnp.asarray(scales),
                                       jnp.asarray(zeros), interpret=True))
    tw = TQ.pack_int4(_t(w_p)) if packed else _t(w_p)
    got = TQM.w4a16_matmul(_t(x), tw, _t(scales), _t(zeros))
    assert TQM.w4a16_matmul.launches == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("packed", [False, True])
def test_int4_linear_matches_jax_xla_path(packed):
    """int4_linear (with a bias, through ops.linear) against the JAX
    int4_linear's dequant path on the CPU."""
    x, w_p, scales, zeros = _kernel_inputs(8)
    b = np.random.RandomState(9).randn(w_p.shape[1]).astype(np.float32)
    jp = {"w_p": JQ.pack_int4(jnp.asarray(w_p)) if packed else jnp.asarray(w_p),
          "scales": jnp.asarray(scales), "zeros": jnp.asarray(zeros)}
    want = np.asarray(JQ.int4_linear(jp, jnp.asarray(x))) + b
    tp = {"w_p": TQ.pack_int4(_t(w_p)) if packed else _t(w_p),
          "scales": _t(scales), "zeros": _t(zeros), "b": _t(b)}
    np.testing.assert_allclose(linear(tp, _t(x)).numpy(), want, rtol=1e-4, atol=1e-4)


def test_int4_linear_act_order_and_padding_match_jax():
    """A perm (act-order) and an activation narrower than the padded K."""
    rng = np.random.RandomState(10)
    K, N, G = 384, 128, 6
    w_p, scales, zeros = make_int4(K, N, G, seed=10)
    perm = rng.permutation(K).astype(np.int32)
    x = rng.randn(3, K - 64).astype(np.float32)
    jp = {"w_p": jnp.asarray(w_p), "scales": jnp.asarray(scales), "zeros": jnp.asarray(zeros),
          "perm": jnp.asarray(perm)}
    tp = {"w_p": _t(w_p), "scales": _t(scales), "zeros": _t(zeros), "perm": _t(perm)}
    np.testing.assert_allclose(TQ.int4_linear(tp, _t(x)).numpy(),
                               np.asarray(JQ.int4_linear(jp, jnp.asarray(x))), rtol=1e-4, atol=1e-4)


def test_pack_unpack_dequant_bit_exact():
    w_p, scales, zeros = make_int4(K=256, N=64, G=4, seed=1)
    jpacked = np.asarray(JQ.pack_int4(jnp.asarray(w_p)))
    tpacked = TQ.pack_int4(_t(w_p))
    assert tpacked.dtype == torch.uint8 and TQ.INT4_PACK_FORMAT == JQ.INT4_PACK_FORMAT
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    np.testing.assert_array_equal(TQ.unpack_int4(tpacked).numpy(),
                                  np.asarray(JQ.unpack_int4(jnp.asarray(jpacked))))
    for w in (w_p, jpacked):
        want = np.asarray(JQ.dequant_int4(jnp.asarray(w), jnp.asarray(scales),
                                          jnp.asarray(zeros), jnp.float32))
        got = TQ.dequant_int4(_t(w), _t(scales), _t(zeros), torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)


def test_gptq_pack_unpack_bit_exact():
    w_p, scales, zeros = make_int4(K=64, N=32, G=4, seed=0)
    qw, qz, sc = TC.pack_gptq(w_p, zeros, scales)
    for got, want in zip((qw, qz, sc), JC.pack_gptq(w_p, zeros, scales)):
        np.testing.assert_array_equal(got, want)
    tout, jout = TC.unpack_gptq(qw, qz, sc), JC.unpack_gptq(qw, qz, sc)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert tout[k].dtype == jout[k].dtype
        np.testing.assert_array_equal(tout[k], jout[k])
    np.testing.assert_array_equal(tout["w_p"], w_p)


def test_gptq_act_order_bit_exact():
    """tests/test_quant.py:44-61's scrambled g_idx: same perm and sorted rows."""
    w_p, scales, zeros = make_int4(K=64, N=32, G=4, seed=0)
    qw, qz, sc = JC.pack_gptq(w_p, zeros, scales)
    g_idx = np.random.RandomState(1).permutation(np.arange(64) // 16).astype(np.int32)
    tout, jout = TC.unpack_gptq(qw, qz, sc, g_idx), JC.unpack_gptq(qw, qz, sc, g_idx)
    assert "perm" in tout and sorted(tout) == sorted(jout)
    for k in jout:
        assert tout[k].dtype == jout[k].dtype
        np.testing.assert_array_equal(tout[k], jout[k])


def test_awq_pack_unpack_bit_exact():
    w_p, scales, zeros = make_int4(K=64, N=32, G=4, seed=2)
    qw, qz, sc = TC.pack_awq(w_p, zeros, scales)
    for got, want in zip((qw, qz, sc), JC.pack_awq(w_p, zeros, scales)):
        np.testing.assert_array_equal(got, want)
    tout, jout = TC.unpack_awq(qw, qz, sc), JC.unpack_awq(qw, qz, sc)
    for k in jout:
        assert tout[k].dtype == jout[k].dtype
        np.testing.assert_array_equal(tout[k], jout[k])
    np.testing.assert_array_equal(tout["w_p"], w_p)


@pytest.mark.parametrize("K", [256, 1024])
def test_gptq_planar_qweight_bit_exact(K):
    w_p, scales, zeros = make_int4(K=K, N=48, G=K // 128, seed=K)
    qw, _, _ = JC.pack_gptq(w_p, zeros, scales)
    got = TC.gptq_planar_qweight(qw)
    np.testing.assert_array_equal(got, JC.gptq_planar_qweight(qw))
    np.testing.assert_array_equal(got, TQ.pack_int4(_t(w_p)).numpy())


def test_pad_canon_int4_bit_exact():
    """K 192 at gs 64 is padded to 256 (a multiple of 2*gs) with zero-scale
    groups, and the perm is extended with the identity."""
    w_p, scales, zeros = make_int4(K=192, N=32, G=3, seed=4)
    perm = np.random.RandomState(4).permutation(192).astype(np.int32)
    canon = lambda: {"w_p": w_p.copy(), "scales": scales.copy(), "zeros": zeros.copy(),
                     "perm": perm.copy()}
    got = {k: v.numpy() for k, v in TQ.pad_int4_groups(
        {k: torch.from_numpy(v) for k, v in canon().items()}).items()}
    want = JH._pad_canon_int4(canon())
    assert got["w_p"].shape == (256, 32)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("K,act_order", [(192, False), (256, True), (512, False)])
def test_map_hf_params_gptq_linear_bit_exact(K, act_order):
    """One GPTQ linear through both loaders: the padded canonical path (K
    192), act-order (K 256 with a scrambled g_idx) and the planar fast path
    (K 512)."""
    from zhilight_tpu.config import ModelConfig as JModelConfig
    from zhilight_tpu_torch.config import ModelConfig as TModelConfig

    gs, N = 64, 96
    rng = np.random.RandomState(K)
    w_p, scales, zeros = make_int4(K=K, N=N, G=K // gs, seed=K)
    qw, qz, sc = JC.pack_gptq(w_p, zeros, scales.astype(np.float16))
    g_idx = np.arange(K, dtype=np.int32) // gs
    if act_order:
        g_idx = rng.permutation(g_idx).astype(np.int32)
    tensors = [("model.layers.0.mlp.down_proj." + k, v)
               for k, v in (("qweight", qw), ("qzeros", qz), ("scales", sc), ("g_idx", g_idx))]
    kw = dict(model_type="llama", num_layers=1, dim_model=N, num_heads=2, dim_head=48,
              num_kv_heads=2, dim_ff=K, vocab_size=64, dtype="float32")
    want = JH.map_hf_params(tensors, JModelConfig(**kw), strict=False, quant_method="gptq")
    got = TH.map_hf_params(tensors, TModelConfig(**kw), strict=False, quant_method="gptq")
    want, got = want["layers"]["0"]["mlp"]["down_proj"], got["layers"]["0"]["mlp"]["down_proj"]
    assert sorted(got) == sorted(want) and ("perm" in got) == act_order
    for k in want:
        w = np.asarray(want[k])
        assert str(got[k].dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_params_to_torch_keeps_int4_leaves():
    """Dense floating leaves take the model dtype; an int4 linear's packed
    weights, f32 scales/zeros and int32 perm keep theirs; its bias is cast."""
    w_p, scales, zeros = make_int4(K=256, N=32, G=2, seed=5)
    params = {
        "embedding": {"w": np.ones((8, 32), np.float32)},
        "planar": {"w_p": np.asarray(JQ.pack_int4(jnp.asarray(w_p))), "scales": scales,
                   "zeros": zeros, "b": np.ones(32, np.float32)},
        "nibbles": {"w_p": w_p, "scales": scales, "zeros": zeros,
                    "perm": np.arange(256, dtype=np.int32)},
    }
    t = params_to_torch(params, "cpu", torch.bfloat16)
    assert t["embedding"]["w"].dtype == torch.bfloat16
    assert t["planar"]["w_p"].dtype == torch.uint8 and t["nibbles"]["w_p"].dtype == torch.int8
    assert t["planar"]["b"].dtype == torch.bfloat16
    for p in (t["planar"], t["nibbles"]):
        assert p["scales"].dtype == torch.float32 and p["zeros"].dtype == torch.float32
        np.testing.assert_array_equal(p["scales"].numpy(), scales)
    assert t["nibbles"]["perm"].dtype == torch.int32


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("K", [1024, 5120, 13824])
def test_w4a16_split_plan_covers_k_in_whole_stages(K, planar):
    """The kernel's split-K plan (chosen on the host): at decode batches the
    decode kernel, and splits that cut the weight rows into that many
    non-empty runs of whole stages covering them exactly, each decode run at
    most DECODE_ROWS rows."""
    rows = K // 2 if planar else K
    unit = TQM.STAGE_ROWS[0]
    stages = -(-rows // unit)
    for M in range(1, 17):
        for N in (1024, 5120, 13824):
            cfg, splits = TQM.plan(M, N, K, planar, sms=132)
            assert cfg == 0 and 1 <= splits <= stages
            per = -(-stages // splits)
            assert per * unit <= TQM.DECODE_ROWS
            runs = [(s * per, min((s + 1) * per, stages)) for s in range(splits)]
            assert all(lo < hi for lo, hi in runs)
            assert runs[0][0] == 0 and runs[-1][1] == stages
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            assert (stages - 1) * unit < rows <= stages * unit
    for M, want in ((17, 1), (64, 1), (65, 2), (512, 2)):
        cfg, splits = TQM.plan(M, 5120, K, planar, sms=132)
        stages = -(-rows // TQM.STAGE_ROWS[cfg])
        assert cfg == want and -(-stages // -(-stages // splits)) == splits
