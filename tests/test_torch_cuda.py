"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: each test skips on a machine without a CUDA GPU (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Inputs are unit-variance bf16 from a numpy seed; int8 pools hold such rows
quantized by the cache's own ``_quantize_rows``. Tolerance: the KV write is
bit-exact, for bf16 and for int8 rows; attention outputs agree within 2e-2
absolute (bf16 output rounding plus the kernels' fp32 probabilities against
the plain version's bf16-rounded ones), over bf16 and over int8 pools; the
int4 matmul within 1e-2 of the largest plain output (bf16 output rounding,
fp32 sums in another order), and so the grouped int4 matmul over expert
stacks; the latent row write is bit-exact and the MLA latent decode within
2e-2 absolute, as the other attention kernels; the FP8 block matmul within
1e-2 of the largest plain output (one bf16 rounding of the output, fp32 sums
in another order); ``int8_linear`` on the card within 1e-2 of the largest
output of the same call on the CPU (the integer product is exact, but the
card may divide through a reciprocal, so a code may differ by one). The
slot-major pools' kernels (separate K and V pools ``[1, N, Hkv, D]``) follow
the same rules: their row writes bit-exact for bf16 and int8 rows, their
decode attention within 2e-2 absolute at head_dim 7 to 256, at its split
edges, over pools holding NaN in every row no sequence attends to, and with V
rows near 6 (outputs in [4, 8), where one bf16 ulp is above the tolerance: the
kernel rounds no probability); back-to-back calls with other split counts
leave the tickets they share with the head-major decodes at zero. The window
side-KV kernels: the two flushes bit-exact; the partial modes of the three
decode kernels within 2e-2 relative to their size (m absolute where l > 0,
l and acc over their largest value: unnormalized sums grow with the
context), and exactly m = -2e38, l = 0, acc = 0 for an empty pool. The fused
write + attend kernels (``ZT_FUSED_KV=1``): the pools after the call
bit-equal to the plain version's, the output within 2e-2 absolute (slot-major,
packed and latent pools; the latent mode rounds no probability). The latent
decode in its three modes is also held at its edges (contexts 0 to 65, this
card's split edges, 128 heads, NaN in every latent row no sequence attends
to, V columns near 6: the normal mode against its twin at the kernel's split count and
within 2e-2 plus 2^-8 of the output's size of the one-max twin, the partial
and fused modes, which round no probability, against the plain version's
fp32 output), and the normal mode against its twin at the serving shape;
back-to-back latent decodes at other split counts, between head-major
decodes, each match and leave the head-major tickets at zero. The grouped
int4 matmul is also held with every expert occupied, one row an expert,
num_occ 0 (nothing written), m-tiles naming experts E and -1 (clamped), at
every decode split count, and to the same bits on a repeated call. The
attention prologues (rope, int8 quantization and the row write in one
launch) are bit-exact against their plain versions: the packed pool's at
head_dim 64 to 256, bf16 and int8 pools, both rope styles, 1 to 2048 tokens,
every int8 code; the latent pool's at DeepSeek-V2-Lite's rows; the slot-major
pools' at head_dim 16, 80, 96, 100, 128 and 256, 1 and 8 KV heads, bf16 and
int8 pools, both rope styles, 1 to 2048 tokens, strided and contiguous rows,
every int8 code, the spare column holding a skipped row's scales. The fused
write + attend engine is held teacher-forced: its decode logits within 2e-2
of the largest unfused logit, and the unfused argmax wherever the unfused
top-2 gap exceeds twice the largest difference. Every kernel test of a model
dtype also runs in fp16 (``DTYPES``: q, rows and model-dtype pools in fp16;
fp16 q over int8 pools; the int4 and FP8 matmuls cast fp16 x to bf16 and
back), under the same tolerances; an fp16 model on each pool layout is held
teacher-forced against the plain path on the CPU, as the fused engine is.
The layered window flush (every layer in one launch, an int8 pool's
requantization in it) is bit-exact against its plain version, scales
included.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig, load_model_config
from zhilight_tpu_torch.config.model_config import RopeConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.kvcache.paged import _quantize_rows, new_kv_cache, rope_write_kv, write_kv
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as L
from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta
from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.ops.cuda import fp8_matmul as F8
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.ops.cuda import paged_attention as PA
from zhilight_tpu_torch.ops.cuda import prefill_attention as P
from zhilight_tpu_torch.ops.cuda import quant_matmul as Q
from zhilight_tpu_torch.ops.cuda import quant_ragged as R
from zhilight_tpu_torch.ops.quant import (fp8_linear, int4_linear, int8_linear, pack_expert_int4,
                                          pack_int4, quantize_int8_weight, ragged_layout)
from zhilight_tpu_torch.ops.rope import apply_rope_rot, build_rope_table
from zhilight_tpu_torch.utils import quant_convert as QC
from zhilight_tpu_torch.utils.quant_convert import planar_from_gptq

S = 16
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(rng, device, *shape):
    return _rand(torch.bfloat16, rng, device, *shape)


# the model dtypes the kernels take: q, rows, outputs and model-dtype pools
DTYPES, DTYPE_IDS = (torch.bfloat16, torch.float16), ("bf16", "fp16")


def _rand(dtype, rng, device, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def _tables(rng, lens, device):
    need = [(int(n) + S - 1) // S for n in lens]
    perm = rng.permutation(sum(need) + 2)
    tables = np.full((len(lens), max(max(need), 1)), -1, np.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o : o + n]
        o += n
    return torch.from_numpy(tables).to(device), len(perm)


@pytest.mark.cuda
@pytest.mark.parametrize("H,D", [(36, 64), (8, 128)])  # MiniCPM-2B's pool, Qwen2.5-14B's
@pytest.mark.parametrize("start,n", [(0, 8), (0, 16), (21, 40), (3205, 512)])
def test_write_rows_hm_is_exact(cuda, start, n, H, D):
    rng = np.random.default_rng(start)
    pages = (start + n) // S + 3
    table = rng.permutation(pages)
    pos = np.arange(start, start + n)
    slots = torch.from_numpy((table[pos // S] * S + pos % S).astype(np.int32)).to(cuda)
    slots[n // 3] = -1
    k, v = _bf16(rng, cuda, n, H, D), _bf16(rng, cuda, n, H, D)
    pool = _bf16(rng, cuda, H, pages * S, 2 * D)
    got = W.write_rows_hm(pool.clone(), k, v, slots)
    assert torch.equal(got, W.write_rows_hm_plain(pool.clone(), k, v, slots))


# the bf16 decode kernel's split edges at Qwen2.5-14B's heads and batch (9
# splits of whole 64-token tiles of each sequence): contexts 1, 64 and 65 (one
# tile, two), 1152 (18 tiles, 2 a split: every split full), 1153 (a last
# split of one token), an empty slot with page-table rows of -1
_SPLIT_CTX = [3712, 1, 0, 64, 65, 1152, 1153, 2000]


def _ctx(rng, ctx, B=8):
    """Contexts: a list as given, or random up to ``ctx`` with slot 0 at
    ``ctx`` and slot 2 empty."""
    if isinstance(ctx, list):
        return np.array(ctx, np.int32)
    lens = rng.integers(1, ctx, B).astype(np.int32)
    lens[0], lens[2] = ctx, 0
    return lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("hq,hkv,D,window,ctx", [
    (36, 36, 64, 0, 700), (32, 8, 128, 0, 700), (16, 1, 64, 50, 700),
    (40, 8, 128, 0, 3712),  # Qwen2.5-14B at its serving batch and context
    (40, 8, 128, 0, _SPLIT_CTX), (40, 8, 128, 700, _SPLIT_CTX),  # a window across splits
    # head dims and groups the bf16 kernel took from this slice on: G 4 at
    # 192, G 16 at 256 and 128, G 20 (two row groups) at 64, a window at 256
    (16, 4, 192, 0, 3000), (32, 2, 256, 0, 3000), (32, 2, 128, 0, 3000),
    (40, 2, 64, 0, 700), (16, 8, 256, 300, _SPLIT_CTX),
])
def test_decode_attention_matches_plain(cuda, dtype, hq, hkv, D, window, ctx):
    """The kernel against the plain version; an empty slot gives zeros; a
    second call gives the same bits (the split merge runs in fixed order)
    and leaves the merge's tickets at zero."""
    rng = np.random.default_rng(hq + D)
    ctx = _ctx(rng, ctx)
    B = len(ctx)
    tables, npages = _tables(rng, ctx, cuda)
    pool = _rand(dtype, rng, cuda, hkv, npages * S, 2 * D)
    args = (_rand(dtype, rng, cuda, B, hq, D), pool, tables, torch.from_numpy(ctx).to(cuda), S,
            1.0 / np.sqrt(D), window)
    got = A.paged_decode_attention_hm(*args)
    want = A.paged_decode_attention_hm_plain(*args)
    empty = torch.from_numpy(ctx == 0).to(cuda)
    assert not got[empty].any()
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert torch.equal(A.paged_decode_attention_hm(*args), got)
    torch.cuda.synchronize()
    assert not any(t.any() for t in A._TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("hq,hkv,D", [(8, 2, 64), (36, 36, 64), (8, 8, 128), (40, 8, 128),
                                      (8, 4, 192), (16, 8, 256), (32, 2, 256)])
def test_prefill_attention_matches_plain(cuda, dtype, hq, hkv, D):
    rng = np.random.default_rng(hq + D)
    TC = 96
    cache_lens = np.array([0, 45, 7], np.int32)
    q_lens = np.array([96, 50, 0], np.int32)
    tables, npages = _tables(rng, cache_lens + q_lens, cuda)
    pool = _rand(dtype, rng, cuda, hkv, npages * S, 2 * D)
    q = _rand(dtype, rng, cuda, len(q_lens) * TC, hq, D)
    lens = lambda a: torch.from_numpy(a).to(cuda)
    args = (q, pool, tables, lens(cache_lens), lens(q_lens), S, 1.0 / np.sqrt(D))
    got = P.paged_prefill_attention_hm_packed(*args)
    want = P.paged_prefill_attention_hm_packed_plain(*args)
    assert torch.isfinite(got).all()
    for s, ql in enumerate(q_lens.tolist()):
        if ql:
            rows = slice(s * TC, s * TC + ql)
            assert (got[rows].float() - want[rows].float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,D", [(36, 36, 64), (40, 8, 128)])  # MiniCPM-2B, Qwen2.5-14B
def test_prefill_attention_long_context_matches_plain(cuda, hq, hkv, D):
    """The last full chunk of a 3712-token prompt: 512 queries at cache_len 3200."""
    rng = np.random.default_rng(hq)
    CL, QL = 3200, 512
    tables, npages = _tables(rng, [CL + QL], cuda)
    pool = _bf16(rng, cuda, hkv, npages * S, 2 * D)
    lens = lambda n: torch.tensor([n], dtype=torch.int32, device=cuda)
    args = (_bf16(rng, cuda, QL, hq, D), pool, tables, lens(CL), lens(QL), S, 1.0 / np.sqrt(D))
    got = P.paged_prefill_attention_hm_packed(*args)
    want = P.paged_prefill_attention_hm_packed_plain(*args)
    assert (got.float() - want.float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,D,window", [(40, 8, 128, 700), (16, 8, 256, 1000),
                                             (8, 4, 192, 300)])
def test_prefill_attention_windowed_long_context_matches_plain(cuda, hq, hkv, D, window):
    """A sliding window over a long cache: a 300-token chunk that starts and
    ends mid-page (cache 3205) and mid-tile, packed beside a short segment."""
    rng = np.random.default_rng(hq + D)
    TC = 320
    cache_lens = np.array([3205, 20], np.int32)
    q_lens = np.array([300, 77], np.int32)
    tables, npages = _tables(rng, cache_lens + q_lens, cuda)
    pool = _bf16(rng, cuda, hkv, npages * S, 2 * D)
    lens = lambda a: torch.from_numpy(a).to(cuda)
    args = (_bf16(rng, cuda, 2 * TC, hq, D), pool, tables, lens(cache_lens), lens(q_lens), S,
            1.0 / np.sqrt(D), window)
    got = P.paged_prefill_attention_hm_packed(*args)
    want = P.paged_prefill_attention_hm_packed_plain(*args)
    assert torch.isfinite(got).all()
    for s, ql in enumerate(q_lens.tolist()):
        rows = slice(s * TC, s * TC + ql)
        assert (got[rows].float() - want[rows].float()).abs().max().item() <= TOL
        assert not got[s * TC + ql : (s + 1) * TC].any()  # padding rows are zeros


def _int8_pool(rng, device, hkv, slots, D):
    """An int8 pool [Hkv, N, 2D] of quantized unit-variance rows and its
    head-major scales [Hkv, N + 1] (last column spare, as the cache keeps it)."""
    k_q, k_s = _quantize_rows(_bf16(rng, device, slots, hkv, D))
    v_q, v_s = _quantize_rows(_bf16(rng, device, slots, hkv, D))
    pool = torch.cat([k_q, v_q], -1).transpose(0, 1).contiguous()
    pad = torch.zeros(hkv, 1, device=device)
    return pool, torch.cat([k_s.t(), pad], 1).contiguous(), torch.cat([v_s.t(), pad], 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("H,D", [(36, 64), (8, 128)])
@pytest.mark.parametrize("start,n", [(0, 8), (21, 40), (3205, 512)])
def test_int8_write_kv_is_exact(cuda, start, n, H, D):
    """write_kv into an int8 cache on the card: the quantized rows go through
    the write kernel (64- or 128-byte halves) and their scales beside them,
    bit-equal to the plain scatter of the same rows; a skipped row leaves no
    trace. The quantization itself is held to the CPU's within one step:
    on the card PyTorch divides by the constant 127 through its reciprocal,
    so a scale may differ by an fp32 ulp."""
    rng = np.random.default_rng(start + D)
    pages = (start + n) // S + 3
    table = rng.permutation(pages)
    pos = np.arange(start, start + n)
    slots = (table[pos // S] * S + pos % S).astype(np.int32)
    slots[n // 3] = -1
    k, v = _bf16(rng, cuda, n, H, D), _bf16(rng, cuda, n, H, D)
    slots_dev = torch.from_numpy(slots).to(cuda)
    cache = new_kv_cache(1, pages, S, H, D, torch.bfloat16, quantized=True, device=cuda)
    before = W.write_rows_hm.launches
    write_kv(cache, 0, k, v, slots_dev)
    assert W.write_rows_hm.launches == before + 1

    (k_q, k_s), (v_q, v_s) = _quantize_rows(k), _quantize_rows(v)
    want = W.write_rows_hm_plain(torch.zeros_like(cache.k[0]), k_q, v_q, slots_dev)
    assert torch.equal(cache.k[0], want)
    keep = torch.from_numpy(slots >= 0).to(cuda)
    for got, sc in ((cache.k_scale[0], k_s), (cache.v_scale[0], v_s)):
        ref = torch.zeros_like(got[:, :-1])
        ref[:, slots_dev[keep].long()] = sc[keep].t()
        assert torch.equal(got[:, :-1], ref)

    cq, cs = _quantize_rows(k.cpu())
    assert torch.allclose(k_s.cpu(), cs, rtol=2.5e-7, atol=0)
    assert (k_q.cpu().int() - cq.int()).abs().max().item() <= 1


def _prologue_slots(rng, T, N, device):
    """T distinct slots of the pool; past one token, one skipped (-1) and one
    past the pool (N + 3): neither writes a row, both scales go to column N."""
    slots = rng.permutation(N)[:T].astype(np.int32)
    if T > 1:
        slots[T // 3], slots[T - 1] = -1, N + 3
    return torch.from_numpy(slots).to(device)


def _rope_tables(rng, T, D, neox, device):
    table = build_rope_table(D, 1e6, RopeConfig(neox_style=neox), 32768, 32768)
    return table.rot_values(torch.from_numpy(rng.integers(0, 32000, T).astype(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("T,Hq,Hkv,D", [
    (16, 36, 36, 64), (8, 40, 8, 128), (1, 40, 8, 128), (33, 32, 8, 128), (8, 16, 4, 192),
    (8, 16, 8, 256), (512, 36, 36, 64), (2048, 40, 8, 128),  # a chunk; four packed chunks
])
def test_rope_write_rows_hm_is_exact(cuda, dtype, T, Hq, Hkv, D, neox, int8):
    """The packed pool's prologue bit-equal to its plain version (the port's
    rope, quantization and row write in PyTorch ops on the card): q rotated,
    the pool, and the scales of the written rows; the spare column holds one
    skipped row's scales. q, k, v are views of one fused qkv output. V rows of
    token 0 hold 1 and c / 127 for every c in -127 ... 127, so the int8
    codes cover every code the quantization gives."""
    rng = np.random.default_rng(T + D + Hq)
    pages = max(T // S + 4, 16)
    N = pages * S
    qkv = _rand(dtype, rng, cuda, T, (Hq + 2 * Hkv) * D)
    # token 0's V rows: 1 and then c / 127 for c = -127 ... 127 in turn
    codes = (torch.arange(-127, 128, device=cuda) / 127).repeat(Hkv * D // 255 + 1)
    row0 = torch.cat([torch.ones(Hkv, 1, device=cuda), codes[: Hkv * (D - 1)].reshape(Hkv, -1)], 1)
    qkv[0, (Hq + Hkv) * D:] = row0.reshape(-1).to(dtype)
    q, k, v = (x.reshape(T, -1, D) for x in torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], -1))
    cos, sin = _rope_tables(rng, T, D, neox, cuda)
    slots = _prologue_slots(rng, T, N, cuda)
    if int8:
        pools = [torch.zeros(Hkv, N, 2 * D, dtype=torch.int8, device=cuda) for _ in "ab"]
        scales = [[torch.full((Hkv, N + 1), -1.0, device=cuda) for _ in "kv"] for _ in "ab"]
    else:
        pool = _rand(dtype, rng, cuda, Hkv, N, 2 * D)
        pools, scales = [pool.clone(), pool.clone()], [[], []]
    before = W.rope_write_rows_hm.launches
    got = W.rope_write_rows_hm(pools[0], q, k, v, cos, sin, neox, slots, *scales[0])
    want = W.rope_write_rows_hm_plain(pools[1], q, k, v, cos, sin, neox, slots, *scales[1])
    torch.cuda.synchronize()
    assert W.rope_write_rows_hm.launches == before + 1
    assert got.shape == (T, Hq, D) and got.is_contiguous() and torch.equal(got, want)
    assert torch.equal(pools[0], pools[1])
    if int8:
        codes = torch.unique(pools[0])
        assert codes.min().item() == -127 and codes.max().item() == 127 and codes.numel() == 255
        skipped = ((slots < 0) | (slots >= N)).nonzero()[:, 0]
        for g, w in zip(scales[0], scales[1]):
            assert torch.equal(g[:, :N], w[:, :N])
            if len(skipped):  # the spare column: one of the skipped rows' scales
                _, sc = _quantize_rows(torch.stack((apply_rope_rot(k, cos, sin, neox), v)))
                cands = torch.cat([sc[0][skipped].t(), sc[1][skipped].t()], 1)
                assert (g[:, N:] == cands).any(1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("T", [1, 8, 33, 512, 2048])
def test_rope_write_rows_2d_is_exact(cuda, dtype, T, neox):
    """The latent pool's prologue at DeepSeek-V2-Lite's shapes (16 heads,
    rows of 512 + 64) bit-equal to its plain version: q_pe a view of the q
    projection [T, 16, 128 + 64], k_pe the strided tail of kv_a [T, 576]."""
    rng = np.random.default_rng(T + 1)
    H, nope, R, Lr = 16, 128, 64, 512
    N = max(T // S + 4, 16) * S
    q = _rand(dtype, rng, cuda, T, H, nope + R)
    kv_a = _rand(dtype, rng, cuda, T, Lr + R)
    c_kv = _rand(dtype, rng, cuda, T, Lr)
    cos, sin = _rope_tables(rng, T, R, neox, cuda)
    slots = _prologue_slots(rng, T, N, cuda)
    pool = _rand(dtype, rng, cuda, 1, N, Lr + R)
    pools = [pool.clone(), pool.clone()]
    before = W.rope_write_rows_2d.launches
    args = (q[..., nope:], c_kv, kv_a[:, Lr:], cos, sin, neox, slots)
    got = W.rope_write_rows_2d(pools[0], *args)
    want = W.rope_write_rows_2d_plain(pools[1], *args)
    torch.cuda.synchronize()
    assert W.rope_write_rows_2d.launches == before + 1
    assert got.shape == (T, H, R) and torch.equal(got, want)
    assert torch.equal(pools[0], pools[1]) and not torch.equal(pools[0], pool)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("T,Hq,Hkv,D,fused_qkv", [
    (8, 32, 8, 80, True), (1, 32, 8, 80, True), (33, 32, 8, 80, False),  # H2O-Danube-1.8B
    (512, 32, 8, 80, True), (2048, 32, 8, 80, True),  # a chunk; four packed chunks
    (8, 4, 1, 16, True), (33, 4, 2, 16, True), (8, 12, 1, 96, True), (8, 16, 8, 96, False),
    (33, 8, 8, 100, True), (8, 40, 8, 128, True), (2048, 40, 8, 128, True), (8, 16, 8, 256, True),
    (8, 8, 1, 256, False),
])
def test_rope_write_rows_pair_is_exact(cuda, dtype, T, Hq, Hkv, D, fused_qkv, neox, int8):
    """The slot-major pools' prologue bit-equal to its plain version (the
    port's rope, quantization and pair write in PyTorch ops on the card): q
    rotated, both pools, and the scales of the written rows; the spare column
    holds one skipped row's scales. q, k, v are views of one fused qkv output
    or contiguous rows. Over int8 pools every V row holds 1 and then c / 127
    for c = -127 ... 127 in turn across the rows, so the codes cover every
    code the quantization gives once enough rows are written."""
    rng = np.random.default_rng(T + D + Hq + Hkv)
    N = max(T // S + 4, 16) * S
    qkv = _rand(dtype, rng, cuda, T, (Hq + 2 * Hkv) * D)
    if int8:
        codes = (torch.arange(T * Hkv * (D - 1), device=cuda) % 255 - 127) / 127
        rows = torch.cat([torch.ones(T, Hkv, 1, device=cuda), codes.reshape(T, Hkv, D - 1)], -1)
        qkv[:, (Hq + Hkv) * D:] = rows.reshape(T, -1).to(dtype)
    q, k, v = (x.reshape(T, -1, D) for x in torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], -1))
    if not fused_qkv:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cos, sin = _rope_tables(rng, T, D, neox, cuda)
    slots = _prologue_slots(rng, T, N, cuda)
    if int8:
        pools = [[torch.zeros(1, N, Hkv, D, dtype=torch.int8, device=cuda) for _ in "kv"]
                 + [torch.full((Hkv, N + 1), -1.0, device=cuda) for _ in "kv"] for _ in "ab"]
    else:
        kv = [_rand(dtype, rng, cuda, 1, N, Hkv, D) for _ in "kv"]
        pools = [[x.clone() for x in kv] for _ in "ab"]
    before = W.rope_write_rows_pair.launches
    got = W.rope_write_rows_pair(*pools[0][:2], q, k, v, cos, sin, neox, slots, *pools[0][2:])
    want = W.rope_write_rows_pair_plain(*pools[1][:2], q, k, v, cos, sin, neox, slots,
                                        *pools[1][2:])
    torch.cuda.synchronize()
    assert W.rope_write_rows_pair.launches == before + 1
    assert got.shape == (T, Hq, D) and got.is_contiguous() and torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(pools[0][:2], pools[1][:2]))
    if not int8:
        assert not torch.equal(pools[0][0], kv[0]) and not torch.equal(pools[0][1], kv[1])
        return
    if Hkv * (D - 1) >= 255 or T >= 512:  # token 0 alone, or enough rows
        codes = torch.unique(torch.cat([p.flatten() for p in pools[0][:2]]))
        assert codes.min().item() == -127 and codes.max().item() == 127 and codes.numel() == 255
    skipped = ((slots < 0) | (slots >= N)).nonzero()[:, 0]
    for g, w in zip(pools[0][2:], pools[1][2:]):
        assert torch.equal(g[:, :N], w[:, :N])
        if len(skipped):  # the spare column: one of the skipped rows' scales
            _, sc = _quantize_rows(torch.stack((apply_rope_rot(k, cos, sin, neox), v)))
            cands = torch.cat([sc[0][skipped].t(), sc[1][skipped].t()], 1)
            assert (g[:, N:] == cands).any(1).all()


@pytest.mark.cuda
def test_rope_write_rows_pair_raises_on_unsupported_cuda_inputs(cuda):
    rng = np.random.default_rng(1)
    T, N = 4, 64

    def case(D, Hkv=2):
        qkv = _bf16(rng, cuda, T, (4 + 2 * Hkv) * D)
        q, k, v = (x.reshape(T, -1, D) for x in torch.split(qkv, [4 * D, Hkv * D, Hkv * D], -1))
        cos, sin = _rope_tables(rng, T, D, True, cuda) if D % 2 == 0 else (
            torch.zeros(T, D, device=cuda), torch.zeros(T, D, device=cuda))
        pool = torch.zeros(1, N, Hkv, D, dtype=torch.bfloat16, device=cuda)
        return pool, q, k, v, cos, sin

    pair = W.rope_write_rows_pair
    slots = torch.arange(T, dtype=torch.int32, device=cuda)
    pool, q, k, v, cos, sin = case(80)
    sc = torch.zeros(2, N + 1, device=cuda)
    with pytest.raises(NotImplementedError):
        pair(pool, pool.clone(), q.float(), k, v, cos, sin, True, slots)                # fp32 q
    with pytest.raises(NotImplementedError):
        pair(pool, pool.clone(), q, k.half(), v, cos, sin, True, slots)                 # fp16 k
    with pytest.raises(NotImplementedError):
        pair(pool.float(), pool.float(), q, k, v, cos, sin, True, slots)                # fp32 pools
    i8 = pool.to(torch.int8)
    with pytest.raises(NotImplementedError):
        pair(i8, i8.clone(), q, k, v, cos, sin, True, slots)                            # int8, no scales
    with pytest.raises(NotImplementedError):
        pair(pool, pool.clone(), q, k, v, cos, sin, True, slots, sc, sc.clone())        # bf16, scales
    with pytest.raises(ValueError):
        pair(i8, i8.clone(), q, k, v, cos, sin, True, slots, sc[:, :N], sc.clone())     # scales [2, N]
    with pytest.raises(ValueError):
        pair(i8, i8.clone(), q, k, v, cos, sin, True, slots, sc.double(), sc.clone())   # fp64 scales
    with pytest.raises(ValueError):
        pair(i8, i8.clone(), q, k, v, cos, sin, True, slots, sc, sc.clone()[:1])        # scales [1, N + 1]
    with pytest.raises(ValueError):
        pair(pool, pool.clone(), q, k, v, cos, sin, True, slots.long())                 # int64 slots
    with pytest.raises(ValueError):
        pair(pool, pool.clone(), q, k[:, :1], v, cos, sin, True, slots)                 # k [T, 1, D]
    with pytest.raises(ValueError):
        pair(pool, pool.clone(), q, k, v, cos[:, :64], sin, True, slots)                # cos [T, 64]
    with pytest.raises(ValueError):
        pair(pool, pool.clone(), q.cpu(), k, v, cos, sin, True, slots)                  # q on the CPU
    for D in (81, 258):                                                                 # odd, > 256
        pool, q, k, v, cos, sin = case(D)
        with pytest.raises(NotImplementedError):
            pair(pool, pool.clone(), q, k, v, cos, sin, True, slots)


@pytest.mark.cuda
def test_prologue_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    rng = np.random.default_rng(0)
    T, D, N = 4, 128, 64
    q, k, v = _bf16(rng, cuda, T, 4, D), _bf16(rng, cuda, T, 2, D), _bf16(rng, cuda, T, 2, D)
    cos, sin = _rope_tables(rng, T, D, True, cuda)
    slots = torch.arange(T, dtype=torch.int32, device=cuda)
    pool = torch.zeros(2, N, 2 * D, dtype=torch.bfloat16, device=cuda)
    hm = W.rope_write_rows_hm
    with pytest.raises(NotImplementedError):
        hm(pool, q.float(), k, v, cos, sin, True, slots)                          # fp32 q
    with pytest.raises(NotImplementedError):
        hm(pool.to(torch.int8), q, k, v, cos, sin, True, slots)                   # int8, no scales
    with pytest.raises(ValueError):
        hm(pool, q, k, v, cos, sin, True, slots.long())                           # int64 slots
    with pytest.raises(ValueError):
        hm(pool, q, k[:, :1], v, cos, sin, True, slots)                           # k [T, 1, D]
    with pytest.raises(ValueError):
        hm(pool, q, k, v, cos[:, :64], sin, True, slots)                          # cos [T, 64]
    wide = _bf16(rng, cuda, T, 2, 2 * D + 8)
    with pytest.raises(ValueError):                                               # rows off 16 B
        hm(pool, q, wide[..., 4:D + 4], v, cos, sin, True, slots)
    with pytest.raises(ValueError):                                               # scales [2, N]
        hm(pool.to(torch.int8), q, k, v, cos, sin, True, slots,
           torch.zeros(2, N, device=cuda), torch.zeros(2, N, device=cuda))
    q72, k72 = _bf16(rng, cuda, T, 4, 72), _bf16(rng, cuda, T, 2, 72)
    cos72, sin72 = _rope_tables(rng, T, 72, True, cuda)
    with pytest.raises(NotImplementedError):                                      # head_dim 72
        hm(torch.zeros(2, N, 144, dtype=torch.bfloat16, device=cuda), q72, k72, k72, cos72,
           sin72, True, slots)
    lat = torch.zeros(1, N, 576, dtype=torch.bfloat16, device=cuda)
    qpe, ckv, kpe = _bf16(rng, cuda, T, 16, 64), _bf16(rng, cuda, T, 512), _bf16(rng, cuda, T, 64)
    cos64, sin64 = _rope_tables(rng, T, 64, False, cuda)
    with pytest.raises(NotImplementedError):
        W.rope_write_rows_2d(lat.float(), qpe, ckv, kpe, cos64, sin64, False, slots)  # fp32 pool
    with pytest.raises(ValueError):
        W.rope_write_rows_2d(lat, qpe, ckv[:, :500], kpe, cos64, sin64, False, slots)  # L + R != X
    with pytest.raises(ValueError):
        W.rope_write_rows_2d(lat, qpe, ckv, kpe, cos64, sin64, False, slots[:2])      # slots [2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("hq,hkv,D,window,ctx", [
    (36, 36, 64, 0, 700), (32, 8, 128, 0, 700), (16, 1, 64, 50, 700), (16, 2, 128, 0, 300),
    (40, 8, 128, 0, 3712),  # Qwen2.5-14B at its serving batch and context
    # the split edges (a window across splits), and the head dims and groups
    # the kernel takes since its redesign: G 16 and 20 (two row groups) at
    # 128 and 64, head_dim 192, head_dim 256 at Gemma-2-9B's 16 / 8 heads
    (40, 8, 128, 0, _SPLIT_CTX), (40, 8, 128, 700, _SPLIT_CTX), (32, 2, 128, 0, 3000),
    (40, 2, 64, 0, 700), (16, 4, 192, 0, 3000), (16, 8, 256, 0, 3712),
    (16, 8, 256, 300, _SPLIT_CTX), (40, 2, 256, 0, _SPLIT_CTX),
])
def test_decode_attention_q_matches_plain(cuda, dtype, hq, hkv, D, window, ctx):
    """The int8 kernel against the plain version and against its twin (the
    plain version in the kernels' rounding order); an empty slot gives zeros;
    a second call gives the same bits and leaves the merge's tickets at zero."""
    rng = np.random.default_rng(hq + D)
    ctx = _ctx(rng, ctx)
    B = len(ctx)
    tables, npages = _tables(rng, ctx, cuda)
    pool, ks, vs = _int8_pool(rng, cuda, hkv, npages * S, D)
    args = (_rand(dtype, rng, cuda, B, hq, D), pool, ks, vs, tables, torch.from_numpy(ctx).to(cuda), S,
            1.0 / np.sqrt(D), window)
    before = A.paged_decode_attention_hm_q.launches
    got = A.paged_decode_attention_hm_q(*args)
    assert A.paged_decode_attention_hm_q.launches == before + 1
    assert not got[torch.from_numpy(ctx == 0).to(cuda)].any()
    for want in (A.paged_decode_attention_hm_q_plain(*args), A.paged_decode_attention_hm_q_twin(*args)):
        assert (got.float() - want.float()).abs().max().item() <= TOL
    assert torch.equal(A.paged_decode_attention_hm_q(*args), got)
    torch.cuda.synchronize()
    assert not any(t.any() for t in A._TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("hq,hkv,D,window", [(8, 2, 64, 0), (36, 36, 64, 0), (8, 8, 128, 0),
                                             (40, 8, 128, 0), (40, 8, 128, 60), (8, 2, 192, 0),
                                             (16, 8, 256, 0), (16, 8, 256, 60)])
def test_prefill_attention_q_matches_plain(cuda, dtype, hq, hkv, D, window):
    rng = np.random.default_rng(hq + D)
    TC = 96
    cache_lens = np.array([0, 45, 7], np.int32)
    q_lens = np.array([96, 50, 0], np.int32)
    tables, npages = _tables(rng, cache_lens + q_lens, cuda)
    pool, ks, vs = _int8_pool(rng, cuda, hkv, npages * S, D)
    q = _rand(dtype, rng, cuda, len(q_lens) * TC, hq, D)
    lens = lambda a: torch.from_numpy(a).to(cuda)
    args = (q, pool, ks, vs, tables, lens(cache_lens), lens(q_lens), S, 1.0 / np.sqrt(D), window)
    got = P.paged_prefill_attention_hm_packed_q(*args)
    want = P.paged_prefill_attention_hm_packed_q_plain(*args)
    assert torch.isfinite(got).all()
    for s, ql in enumerate(q_lens.tolist()):
        if ql:
            rows = slice(s * TC, s * TC + ql)
            assert (got[rows].float() - want[rows].float()).abs().max().item() <= TOL
    # the one-segment wrapper is the packed kernel with NS = 1
    one = P.paged_prefill_attention_hm_q(q[TC : 2 * TC], pool, ks, vs, tables[1], 45, 50, S,
                                         1.0 / np.sqrt(D), window)
    assert torch.equal(one[:50], got[TC : TC + 50])


@pytest.mark.cuda
# MiniCPM-2B, Qwen2.5-14B; head dims 192 and 256
@pytest.mark.parametrize("hq,hkv,D", [(36, 36, 64), (40, 8, 128), (16, 8, 192), (16, 8, 256)])
def test_prefill_attention_q_long_context_matches_plain(cuda, hq, hkv, D):
    """The last full chunk of a 3712-token prompt: 512 queries at cache_len 3200."""
    rng = np.random.default_rng(hq)
    CL, QL = 3200, 512
    tables, npages = _tables(rng, [CL + QL], cuda)
    pool, ks, vs = _int8_pool(rng, cuda, hkv, npages * S, D)
    lens = lambda n: torch.tensor([n], dtype=torch.int32, device=cuda)
    args = (_bf16(rng, cuda, QL, hq, D), pool, ks, vs, tables, lens(CL), lens(QL), S,
            1.0 / np.sqrt(D))
    got = P.paged_prefill_attention_hm_packed_q(*args)
    want = P.paged_prefill_attention_hm_packed_q_plain(*args)
    assert (got.float() - want.float()).abs().max().item() <= TOL


@pytest.mark.cuda
def test_int8_kv_engine_on_gpu(cuda):
    """A small bf16 model served with kv_dtype="int8": every attention call
    goes through the two int8 kernels, beam copies and a swap round trip move
    int8 rows with their scales, and calc_logits runs beside the int8 pool."""
    cfg = L.ModelConfig(model_type="llama", num_layers=2, dim_model=256, num_heads=4, dim_head=64,
                        num_kv_heads=2, dim_ff=512, vocab_size=128, dtype="bfloat16")
    ecfg = EngineConfig(max_model_len=256,
                        cache=CacheConfig(page_size=16, num_pages=64, kv_dtype="int8"),
                        scheduler=SchedulerConfig(max_batch=4, chunk_size=64, prefill_buckets=(64,)))
    llm = LLM(model_config=cfg, params=L.init_params(cfg, 0, cuda), engine_config=ecfg, device=cuda)
    ex = llm.executor
    assert ex.cache.quantized and ex.cache.k[0].dtype == torch.int8
    counters = (A.paged_decode_attention_hm_q, P.paged_prefill_attention_hm_packed_q,
                A.paged_decode_attention_hm, P.paged_prefill_attention_hm_packed)
    before = [f.launches for f in counters]
    prompts = [np.random.default_rng(i).integers(2, 128, n).tolist() for i, n in enumerate((40, 7, 100))]
    with DynamicBatchGenerator(llm) as gen:
        res = gen.batch_generate(prompts, [GeneratorArg(max_length=8)] * 3, timeout=300)
        beam = gen.generate(prompts[1], GeneratorArg(beam_size=2, max_length=6), timeout=300)
    assert all(len(r.outputs[0].token_ids) == 8 or r.outputs[0].finish_reason == "stop" for r in res)
    assert len(beam.outputs) >= 1
    used = [f.launches - b for f, b in zip(counters, before)]
    assert used[0] > 0 and used[1] > 0 and used[2] == 0 and used[3] == 0
    snap = [[a.clone() for a in arrays] for arrays in ex.cache.arrays()]
    rows = np.arange(0, 32, dtype=np.int32)
    ex.swap_in_rows(rows + 512, ex.swap_out_rows(rows))
    ex.copy_slots(rows, rows + 640)
    for arrays, now in zip(snap, ex.cache.arrays()):
        for a, b in zip(arrays, now):
            assert torch.equal(b[:, 512:544], a[:, :32]) and torch.equal(b[:, 640:672], a[:, :32])
    logits = llm.calc_logits(prompts[0])
    assert logits.shape == (40, 128) and np.isfinite(logits).all()


def _int4(rng, K, N, gs, device, planar):
    w = rng.integers(0, 16, (K, N)).astype(np.int8)
    scales = ((rng.random((K // gs, N)) + 0.5) * 0.01).astype(np.float32)
    zeros = rng.integers(1, 16, (K // gs, N)).astype(np.float32)
    w = torch.from_numpy(w)
    w = pack_int4(w) if planar else w
    return w.to(device), torch.from_numpy(scales).to(device), torch.from_numpy(zeros).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("M", [1, 8, 16, 37, 128, 512])
@pytest.mark.parametrize("K,N,gs", [(512, 256, 128), (768, 200, 64), (384, 136, 32), (256, 64, 256),
                                    (768, 200, 48), (1024, 1032, 128)])
def test_w4a16_matmul_matches_plain(cuda, dtype, planar, M, K, N, gs):
    """Both weight formats, ragged M and N (N % 16 == 8 too), groups of 32 to
    K and of 48 (a group size the kernel's 32-row stages cross). Tolerance:
    max |err| <= 1e-2 * max |plain| (the bf16 output rounding; fp32 sums in
    another order; the dequantized weights are the same bf16 values)."""
    rng = np.random.default_rng(M + K + N)
    w, scales, zeros = _int4(rng, K, N, gs, cuda, planar)
    x = _rand(dtype, rng, cuda, M, K)
    got = Q.w4a16_matmul(x, w, scales, zeros)
    want = Q.w4a16_matmul_plain(x, w, scales, zeros)
    assert got.shape == (M, N) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.cuda
def test_w4a16_matmul_split_k_is_deterministic(cuda):
    """Qwen2.5-14B's down_proj K over k/v's N at a decode batch: a plan with
    several splits, held to the plain version, and a second call gives the
    same bits (the partials are summed in split order; the tickets reset)."""
    rng = np.random.default_rng(11)
    K, N = 13824, 1024
    w, scales, zeros = _int4(rng, K, N, 128, cuda, True)
    x = _bf16(rng, cuda, 8, K)
    got = Q.w4a16_matmul(x, w, scales, zeros)
    assert Q._DEVICES[got.device].plans[8, N, K, True][1] > 1
    want = Q.w4a16_matmul_plain(x, w, scales, zeros)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
    assert torch.equal(got, Q.w4a16_matmul(x, w, scales, zeros))


@pytest.mark.cuda
def test_int4_linear_with_perm_and_padding_on_gpu(cuda):
    """int4_linear gathers x by the act-order perm and zero-pads K before the
    kernel; the same call through the plain version agrees."""
    rng = np.random.default_rng(3)
    K, N, gs = 384, 128, 64
    w, scales, zeros = _int4(rng, K, N, gs, cuda, False)
    perm = torch.from_numpy(rng.permutation(K).astype(np.int32)).to(cuda)
    x = _bf16(rng, cuda, 5, K - gs)  # the last group is padding
    p = {"w_p": w, "scales": scales, "zeros": zeros, "perm": perm}
    before = Q.w4a16_matmul.launches
    got = int4_linear(p, x)
    assert Q.w4a16_matmul.launches == before + 1
    xp = torch.nn.functional.pad(x, (0, gs)).index_select(-1, perm)
    want = Q.w4a16_matmul_plain(xp, w, scales, zeros)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.cuda
def test_gptq_planar_repack_on_gpu_is_bit_exact(cuda):
    """The loader repacks GPTQ qweight on the GPU: bit for bit the host's."""
    qweight = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2**32, (640, 1024), dtype=np.uint32).astype(np.int32))
    assert torch.equal(planar_from_gptq(qweight.to(cuda)).cpu(), planar_from_gptq(qweight))


def _write_qwen2_int4(path, method):
    """A tiny Qwen2 int4 checkpoint (2 layers, dim 256, 4 heads of 64, 2 KV
    heads, ff 512, vocab 128, group 64) as pytorch_model.bin + config.json."""
    rng = np.random.default_rng(1)
    D, FF, V, GS = 256, 512, 128, 64
    state = {"model.embed_tokens.weight": rng.standard_normal((V, D)) * 0.5,
             "model.norm.weight": np.ones(D), "lm_head.weight": rng.standard_normal((V, D)) * 0.1}
    lin = {"self_attn.q_proj": (D, 256), "self_attn.k_proj": (D, 128), "self_attn.v_proj": (D, 128),
           "self_attn.o_proj": (256, D), "mlp.gate_proj": (D, FF), "mlp.up_proj": (D, FF),
           "mlp.down_proj": (FF, D)}
    for i in range(2):
        pre = f"model.layers.{i}."
        for name, (K, N) in lin.items():
            w = rng.integers(0, 16, (K, N)).astype(np.int8)
            scales = ((rng.random((K // GS, N)) + 0.5) * (0.25 / np.sqrt(K))).astype(np.float16)
            zeros = rng.integers(1, 16, (K // GS, N)).astype(np.float32)
            pack = QC.pack_gptq if method == "gptq" else QC.pack_awq
            for k, v in zip(("qweight", "qzeros", "scales"), pack(w, zeros, scales)):
                state[pre + name + "." + k] = v
            if name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
                state[pre + name + ".bias"] = rng.standard_normal(N) * 0.1
        state[pre + "input_layernorm.weight"] = np.ones(D)
        state[pre + "post_attention_layernorm.weight"] = np.ones(D)
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32) if v.dtype == np.float64 else v)
                for k, v in state.items()}, path / "pytorch_model.bin")
    cfg = {"model_type": "qwen2", "hidden_size": D, "intermediate_size": FF,
           "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "vocab_size": V, "max_position_embeddings": 256, "rope_theta": 1e6,
           "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
           "quantization_config": {"quant_method": method, "bits": 4, "group_size": GS}}
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


def _first_token_logits(llm, prompt):
    ex, cfg = llm.executor, llm.model_config
    n, pages = len(prompt), (len(prompt) + 15) // 16
    i32 = dict(dtype=torch.int32, device=ex.device)
    cache = new_kv_cache(cfg.num_layers, pages, 16, cfg.num_kv_heads, cfg.dim_head,
                         cfg.torch_dtype, device=ex.device)
    meta = PrefillMeta(torch.arange(n, **i32), torch.arange(n, **i32), torch.arange(pages, **i32),
                       torch.tensor(0, **i32), torch.tensor(n, **i32))
    with torch.no_grad():
        logits, _ = L.forward_prefill(ex.params, cfg, ex.rope, torch.tensor(prompt, **i32), meta, cache)
    return logits.float().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gptq", "awq"])
def test_llm_model_path_on_gpu(cuda, tmp_path, method):
    """LLM(model_path=...) on the GPU: the loader converts on the device (GPTQ
    repack, AWQ unpack and pack), every projection runs the kernel, and the
    bf16 first-token logits agree with the CPU's fp32 plain path within 5e-2
    of the largest logit (bf16 activations and weights through 2 layers)."""
    path = _write_qwen2_int4(tmp_path, method)
    ecfg = EngineConfig(max_model_len=128, cache=CacheConfig(page_size=16, num_pages=64),
                        scheduler=SchedulerConfig(max_batch=4, chunk_size=64, prefill_buckets=(64,)))
    gpu = LLM(model_path=path, engine_config=ecfg, device=cuda)
    q = gpu.executor.params["layers"]["0"]["attn"]["q_proj"]
    assert q["w_p"].is_cuda and q["w_p"].dtype == torch.uint8 and q["scales"].dtype == torch.float32
    cfg, _, _ = load_model_config(path)
    cpu = LLM(model_path=path, model_config=dataclasses.replace(cfg, dtype="float32"),
              engine_config=ecfg, device="cpu")
    prompt = np.random.default_rng(2).integers(2, 128, 40).tolist()
    before = Q.w4a16_matmul.launches
    got = _first_token_logits(gpu, prompt)
    assert Q.w4a16_matmul.launches - before == 7 * 2
    want = _first_token_logits(cpu, prompt)
    assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()
    with DynamicBatchGenerator(gpu) as gen:
        res = gen.batch_generate([prompt, prompt[:7]], [GeneratorArg(max_length=8)] * 2, timeout=300)
    assert all(len(r.outputs[0].token_ids) == 8 or r.outputs[0].finish_reason == "stop"
               for r in res)


@pytest.mark.cuda
def test_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    """A CUDA tensor never reaches a plain version: what the kernels do not
    take raises."""
    q = torch.zeros(2, 4, 64, device=cuda)  # fp32
    pool = torch.zeros(4, 64, 128, device=cuda)
    tables = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm(q, pool, tables, ctx, S, 0.125)
    with pytest.raises(NotImplementedError):
        P.paged_prefill_attention_hm_packed(q.reshape(8, 1, 64).expand(8, 4, 64).contiguous(),
                                            pool, tables, ctx, ctx, S, 0.125)
    w, scales, zeros = _int4(np.random.default_rng(0), 256, 64, 128, cuda, True)
    with pytest.raises(NotImplementedError):
        Q.w4a16_matmul(torch.zeros(2, 256, device=cuda), w, scales, zeros)  # fp32 x
    # the int8 kernels take bf16 q over an int8 pool with fp32 head-major scales
    qb = q.to(torch.bfloat16)
    pool8 = torch.zeros(4, 64, 128, dtype=torch.int8, device=cuda)
    sc = torch.zeros(4, 65, device=cuda)
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm_q(q, pool8, sc, sc, tables, ctx, S, 0.125)       # fp32 q
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm_q(qb, pool.to(torch.bfloat16), sc, sc, tables, ctx, S, 0.125)
    with pytest.raises(ValueError):
        A.paged_decode_attention_hm_q(qb, pool8, sc[:, :10], sc, tables, ctx, S, 0.125)
    with pytest.raises(NotImplementedError):  # the partial mode takes what the kernel takes
        A.paged_decode_attention_hm_q(q, pool8, sc, sc, tables, ctx, S, 0.125, emit_partial=True)
    # head_dim 256: every head-major kernel runs it (the int8 decode since its
    # redesign, and it matches its plain version); head_dim 96 (a slot-major
    # pool in the engine) no head-major kernel takes
    q256, pool256 = torch.zeros(2, 4, 256, dtype=torch.bfloat16, device=cuda), torch.zeros(
        4, 64, 512, dtype=torch.bfloat16, device=cuda)
    assert not A.paged_decode_attention_hm(q256, pool256, tables, ctx, S, 0.125).isnan().any()
    assert P.paged_prefill_attention_hm_packed(q256, pool256, tables[:1], ctx[:1], ctx[:1], S,
                                               0.125).shape == q256.shape
    pool8_256 = pool256.to(torch.int8)
    args256 = (q256, pool8_256, sc, sc, tables, ctx, S, 0.125)
    assert torch.equal(A.paged_decode_attention_hm_q(*args256),
                       A.paged_decode_attention_hm_q_plain(*args256))
    assert P.paged_prefill_attention_hm_packed_q(q256, pool8_256, sc, sc, tables[:1], ctx[:1],
                                                 ctx[:1], S, 0.125).shape == q256.shape
    q96 = torch.zeros(2, 4, 96, dtype=torch.bfloat16, device=cuda)
    pool96 = torch.zeros(4, 64, 192, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm(q96, pool96, tables, ctx, S, 0.125)
    with pytest.raises(NotImplementedError):
        P.paged_prefill_attention_hm_packed(q96, pool96, tables[:1], ctx[:1], ctx[:1], S, 0.125)
    # the latent decode is built for bf16 rows of k_dim 576 / v_dim 512
    lat = torch.zeros(64, 576, dtype=torch.bfloat16, device=cuda)
    q576 = torch.zeros(2, 4, 576, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        A.paged_mla_decode(q576.float(), lat.float(), tables, ctx, S, 0.1, v_dim=512)  # fp32
    with pytest.raises(NotImplementedError):
        A.paged_mla_decode(q576[..., :192].contiguous(), lat, tables, ctx, S, 0.1, v_dim=128)
    with pytest.raises(NotImplementedError):
        A.paged_mla_decode(q576.float(), lat, tables, ctx, S, 0.1, v_dim=512, emit_partial=True)
    # the window flushes take int8 side rows only for an int8 pool, and Kw <= S
    with pytest.raises(ValueError):
        W.flush_side_rows_hm(pool8, torch.zeros(2, 4, 4, 128, device=cuda), ctx, ctx, tables, S)
    with pytest.raises(ValueError):
        W.flush_side_rows_2d(lat, torch.zeros(2, S + 1, 576, dtype=torch.bfloat16, device=cuda),
                             ctx, ctx, tables, S)
    with pytest.raises(ValueError):
        W.flush_side_rows_2d(lat, torch.zeros(2, 4, 576, dtype=torch.bfloat16, device=cuda),
                             ctx.long(), ctx, tables, S)
    # the grouped int4 matmul takes bf16 rows and the shapes the reference
    # routes to its kernel (N % 128, group size % 32, groups inside a plane)
    te, occ = torch.zeros(2, dtype=torch.int32, device=cuda), torch.ones(1, dtype=torch.int32, device=cuda)
    for K, N, gs, dtype in ((256, 128, 128, torch.float32), (256, 64, 128, torch.bfloat16),
                            (256, 128, 16, torch.bfloat16), (384, 128, 128, torch.bfloat16)):
        w_p, sc3, z3 = _expert_stack(np.random.default_rng(0), cuda, 2, K, N, gs)
        with pytest.raises(NotImplementedError):
            R.w4a16_ragged_matmul(torch.zeros(16, K, dtype=dtype, device=cuda), w_p, sc3, z3, te, occ)


# ---------------------------------------------------------------------------
# MLA latent pool and MoE expert stacks (DeepSeek-V2-Lite's shapes)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("X,dtype", [(576, torch.bfloat16), (640, torch.bfloat16),
                                     (36, torch.bfloat16), (21, torch.float32), (7, torch.int8)])
@pytest.mark.parametrize("start,n", [(0, 8), (21, 40), (2304, 512)])
def test_write_rows_2d_is_exact(cuda, start, n, X, dtype):
    rng = np.random.default_rng(start + X)
    pages = (start + n) // S + 3
    table = rng.permutation(pages)
    pos = np.arange(start, start + n)
    slots = torch.from_numpy((table[pos // S] * S + pos % S).astype(np.int32)).to(cuda)
    slots[n // 3] = -1
    mk = lambda *shape: (_bf16(rng, cuda, *shape).float() * 20).to(dtype)
    rows, pool = mk(n, X), mk(1, pages * S, X)
    got = W.write_rows_2d(pool.clone(), rows, slots)
    assert got.shape == pool.shape
    assert torch.equal(got, W.write_rows_2d_plain(pool.clone(), rows, slots))
    # a 2-D pool, and rows in another dtype than the pool's (cast first)
    got = W.write_rows_2d(pool[0].clone(), rows.float(), slots)
    assert torch.equal(got, W.write_rows_2d_plain(pool[0].clone(), rows.float(), slots))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("B,H,ctx_max,stored", [(8, 16, 2816, 576), (3, 16, 300, 576),
                                                (8, 16, 1000, 640), (2, 5, 130, 576),
                                                (1, 40, 3000, 576)])
def test_mla_decode_matches_plain(cuda, dtype, B, H, ctx_max, stored):
    rng = np.random.default_rng(B + ctx_max)
    ctx = rng.integers(1, ctx_max, B).astype(np.int32)
    ctx[0] = ctx_max
    if B > 2:
        ctx[2] = 0
    tables, npages = _tables(rng, ctx, cuda)
    pool = _rand(dtype, rng, cuda, npages * S, stored)
    q = _rand(dtype, rng, cuda, B, H, 576)
    args = (q, pool, tables, torch.from_numpy(ctx).to(cuda), S, 1.0 / np.sqrt(192))
    got = A.paged_mla_decode(*args, v_dim=512)
    want = A.paged_mla_decode_plain(*args, v_dim=512)
    assert got.shape == (B, H, 512) and torch.isfinite(got).all()
    if B > 2:
        assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert (got.float() - want.float()).abs().max().item() <= TOL
    # and against its twin, which rounds the unnormalized p as the kernel does
    twin = A.paged_mla_decode_twin(*args, 512)
    assert (got.float() - twin.float()).abs().max().item() <= TOL
    # the head-major entry point's latent mode is the same kernel
    hm = A.paged_decode_attention_hm(q, pool[None], *args[2:], v_dim=512)
    assert torch.equal(hm, got)


def _expert_stack(rng, device, E, K, N, gs, pad_groups=0):
    q = torch.from_numpy(rng.integers(0, 16, (E, K, N)).astype(np.int8)).to(device)
    s = torch.from_numpy((rng.random((E, K // gs, N)) * 0.004 + 0.001).astype(np.float32)).to(device)
    z = torch.from_numpy(rng.integers(1, 16, (E, K // gs, N)).astype(np.float32)).to(device)
    if pad_groups:  # the loader's zero-scale pad groups at the end of K
        s[:, -pad_groups:] = 0
    return pack_expert_int4(q), s, z


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R_,TM,E,K,N,gs,pad", [
    (48, 8, 64, 2048, 1408, 128, 0),    # DeepSeek-V2-Lite decode, gate/up
    (48, 8, 64, 1536, 2048, 128, 1),    # ... down, K 1408 padded to 1536
    (3072, 64, 64, 2048, 1408, 128, 0), # a 512-token chunk
    (700, 64, 8, 256, 128, 64, 0),
    (5, 8, 16, 128, 256, 32, 0),        # few rows, many experts
    (100, 32, 4, 256, 384, 128, 0),
])
def test_w4a16_ragged_matmul_matches_plain(cuda, dtype, R_, TM, E, K, N, gs, pad):
    rng = np.random.default_rng(R_ + K)
    flat = rng.integers(0, E, R_)
    flat[flat == 1] = 0  # an expert without rows
    w_p, s, z = _expert_stack(rng, cuda, E, K, N, gs, pad)
    _, dest, tile_expert, num_occ, mp = ragged_layout(torch.from_numpy(flat).to(cuda), E + 1, TM,
                                                      occ_experts=E)
    x = torch.zeros(mp, K, dtype=dtype, device=cuda)
    x[dest] = _rand(dtype, rng, cuda, R_, K)
    got = R.w4a16_ragged_matmul(x, w_p, s, z, tile_expert, num_occ)
    want = R.w4a16_ragged_matmul_plain(x, w_p, s, z, tile_expert, num_occ)
    got, want = got[dest].float(), want[dest].float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2


def _ragged_inputs(rng, device, flat, TM, K, N, pad=0, E=64):
    """DeepSeek-V2-Lite's stack geometry (group 128) for E experts, rows laid
    out as models/moe.py lays them out (E + 1 groups, the last an overflow
    bucket)."""
    w_p, s, z = _expert_stack(rng, device, E, K, N, 128, pad)
    _, dest, tile_expert, num_occ, mp = ragged_layout(
        torch.from_numpy(np.asarray(flat, np.int32)).to(device), E + 1, TM, occ_experts=E)
    x = torch.zeros(mp, K, dtype=torch.bfloat16, device=device)
    x[dest] = _bf16(rng, device, len(flat), K)
    if pad:
        x[:, K - 128 * pad:] = 0
    return x, w_p, s, z, dest, tile_expert, num_occ


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,pad", [(2048, 1408, 0), (1536, 2048, 1)])  # gate/up, padded down
@pytest.mark.parametrize("case", ["every_expert", "one_row_an_expert", "decode_48"])
def test_w4a16_ragged_matmul_edges(cuda, case, K, N, pad):
    """Every expert occupied at TM 8, one row an expert over all 64, a decode
    step's 48 rows: against the plain version at every decode split count the
    kernel takes, and a repeated call to the same bits."""
    rng = np.random.default_rng(K + len(case))
    flat = {"every_expert": np.concatenate([rng.permutation(64), rng.permutation(64)]),
            "one_row_an_expert": np.arange(64),
            "decode_48": np.concatenate([rng.permutation(63)[:6] for _ in range(8)])}[case]
    x, w_p, s, z, dest, te, occ = _ragged_inputs(rng, cuda, flat, 8, K, N, pad)
    args = (x, w_p, s, z, te, occ)
    want = R.w4a16_ragged_matmul_plain(*args)[dest]
    got = R.w4a16_ragged_matmul(*args)
    assert _rel(got[dest], want) <= 1e-2 and torch.isfinite(got[dest]).all()
    live = slice(0, int(occ[0]) * 8)  # rows past num_occ are not written
    assert torch.equal(got[live], R.w4a16_ragged_matmul(*args)[live])
    stages = K // 2 // 64
    for n in range(2, stages + 1):  # at most 640 weight rows (10 stages) a split
        per = -(-stages // n)
        if -(-stages // per) != n:
            continue
        out = torch.empty_like(got)
        R._run(*args, out, (0, n))
        assert _rel(out[dest], want) <= 1e-2, n


@pytest.mark.cuda
def test_w4a16_ragged_matmul_skips_and_clamps_tiles(cuda):
    """num_occ 0 writes nothing; m-tiles naming expert E (the overflow
    bucket's id) and -1 take experts E - 1 and 0."""
    rng = np.random.default_rng(3)
    flat = np.concatenate([rng.permutation(63)[:6] for _ in range(8)])
    x, w_p, s, z, dest, te, occ = _ragged_inputs(rng, cuda, flat, 8, 2048, 1408)
    out = torch.full((x.shape[0], 1408), float("nan"), dtype=torch.bfloat16, device=cuda)
    R._run(x, w_p, s, z, te, torch.zeros_like(occ), out)
    torch.cuda.synchronize()
    assert out.isnan().all()
    named = te.clone()
    named[0], named[1] = 64, -1
    got = R.w4a16_ragged_matmul(x, w_p, s, z, named, occ)[:16]
    want = R.w4a16_ragged_matmul_plain(x, w_p, s, z, named.clamp(0, 63), occ)[:16]
    assert _rel(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", ["path", "short_splits", "long_splits"])
def test_mla_decode_at_a_tp_rank_matches_plain(cuda, ctx):
    """The latent decode at a TP=2 rank of DeepSeek-V2-Lite (8 of its 16
    heads, the whole 576 / 512 latent), batch 4: the tp phase's contexts and
    the split edges of the plan those shapes pick (runs of 16 and of 64
    tokens a split, one token past), against the plain version and the twin
    at the kernel's split count."""
    B, H, maxp = 4, 8, 2048 // S
    sp = A.mla_plan(cuda, B, H, maxp * S)
    ctx = {"path": [1532, 532, 1, 0], "short_splits": [0, 1, 16 * sp, 16 * sp + 1],
           "long_splits": [min(64 * sp, 2046), min(64 * sp + 1, 2047), 65, 2047]}[ctx]
    rng = np.random.default_rng(sum(ctx))
    tables, npages = _tables(rng, ctx, cuda)
    args = (_bf16(rng, cuda, B, H, 576), _bf16(rng, cuda, npages * S, 576), tables,
            torch.tensor(ctx, dtype=torch.int32, device=cuda), S, 1.0 / np.sqrt(192))
    got = A.paged_mla_decode(*args, v_dim=512)
    assert got.shape == (B, H, 512) and torch.isfinite(got).all()
    assert not got[torch.tensor(ctx) == 0].any()
    want = A.paged_mla_decode_plain(*args, v_dim=512)
    twin = A.paged_mla_decode_twin(*args, 512, A.mla_plan(cuda, B, H, tables.shape[1] * S))
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert (got.float() - twin.float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 512])
def test_rope_write_rows_2d_at_a_tp_rank_is_exact(cuda, T):
    """The latent pool's prologue at a TP=2 rank of DeepSeek-V2-Lite (8
    heads' q_pe, the whole latent row): a decode step's 4 rows, a chunk."""
    rng = np.random.default_rng(T + 7)
    H, nope, R, Lr = 8, 128, 64, 512
    N = max(T // S + 4, 16) * S
    q = _bf16(rng, cuda, T, H, nope + R)
    kv_a = _bf16(rng, cuda, T, Lr + R)
    cos, sin = _rope_tables(rng, T, R, True, cuda)
    pool = _bf16(rng, cuda, 1, N, Lr + R)
    pools = [pool.clone(), pool.clone()]
    args = (q[..., nope:], _bf16(rng, cuda, T, Lr), kv_a[:, Lr:], cos, sin, True,
            _prologue_slots(rng, T, N, cuda))
    got = W.rope_write_rows_2d(pools[0], *args)
    assert torch.equal(got, W.rope_write_rows_2d_plain(pools[1], *args))
    assert torch.equal(pools[0], pools[1]) and not torch.equal(pools[0], pool)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,pad", [(2048, 1408, 0), (1536, 2048, 1)])  # gate/up, padded down
@pytest.mark.parametrize("R_,TM", [(48, 8), (3072, 64)])
def test_w4a16_ragged_matmul_over_an_expert_shard(cuda, R_, TM, K, N, pad):
    """A TP=2 rank's share of DeepSeek-V2-Lite's experts (32 of 64, top 6):
    the pairs routed to the other rank's experts sit in the overflow bucket,
    past the occupied tiles, as models/moe.py lays them out; the local pairs'
    rows against the plain version."""
    rng = np.random.default_rng(R_ + K)
    flat = np.concatenate([rng.permutation(64)[:6] for _ in range(R_ // 6)]) - 32
    valid = (flat >= 0) & (flat < 32)
    x, w_p, s, z, dest, te, occ = _ragged_inputs(rng, cuda, np.where(valid, flat, 32), TM, K, N,
                                                 pad, E=32)
    # dest follows the rows sorted by expert: the local pairs first, then the bucket
    mine = dest[: int(valid.sum())]
    assert 0 < len(mine) < R_ and int(mine.max()) < int(occ[0]) * TM
    args = (x, w_p, s, z, te, occ)
    got = R.w4a16_ragged_matmul(*args)[mine]
    assert torch.isfinite(got).all()
    assert _rel(got, R.w4a16_ragged_matmul_plain(*args)[mine]) <= 1e-2


def _latent_case(rng, device, ctx, H, kind):
    """Latent decode inputs at batch len(ctx): q [B, H, 576], a pool [N, 576]
    (kind "v6": V columns near 6; "nan": a poisoned copy with NaN in every
    row no sequence attends to, beside the clean pool), tables, lengths."""
    ctx = np.array(ctx, np.int32)
    tables, npages = _tables(rng, ctx, device)
    pool = _bf16(rng, device, npages * S, 576)
    if kind == "v6":
        pool[:, :512] = _v6(rng, device, npages * S, 512)
    cd = torch.from_numpy(ctx).to(device)
    used = pool
    if kind == "nan":
        used = torch.full_like(pool, float("nan"))
        keep = _read_slots(tables, cd, 0).to(device)
        used[keep] = pool[keep]
    return _bf16(rng, device, len(ctx), H, 576), pool, used, tables, cd


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "nan", "v6"])
@pytest.mark.parametrize("H", [16, 128])
def test_latent_decode_modes_at_their_edges(cuda, H, kind):
    """Rows 2b, 2bp and the fused latent mode at contexts 0, 1, 15, 16, 64,
    65 and this card's split edges (runs of 16 tokens a split and one past),
    at DeepSeek-V2-Lite's 16 heads and DeepSeek-V2's 128: 2b against its
    twin (and, but for V near 6, the plain version), 2bp and the fused mode
    against the plain versions (their fp32 outputs for V near 6), the fused
    mode's written rows bit-exact. For V near 6 the normal mode is also held
    within 2e-2 plus 2^-8 of the output's size of the one-max twin."""
    rng = np.random.default_rng(H + len(kind))
    sp = A.mla_plan(cuda, 8, 16, 2816)
    ctx = [0, 1, 15, 16, 64, 65, 16 * sp, 16 * sp + 1]
    scale = 1.0 / np.sqrt(192)
    q, pool, used, tables, cd = _latent_case(rng, cuda, ctx, H, kind)
    live = cd > 0
    qp = q.float() if kind == "v6" else q
    got = A.paged_mla_decode(q, used, tables, cd, S, scale, v_dim=512)
    assert torch.isfinite(got).all() and not got[~live].any()
    # the twin at the kernel's split count (p rounded against the same running max)
    splits = A.mla_plan(cuda, 8, H, tables.shape[1] * S)
    twin = A.paged_mla_decode_twin(qp, pool, tables, cd, S, scale, 512, splits)
    assert (got.float() - twin.float()).abs().max().item() <= TOL
    if kind == "v6":
        assert twin[live].abs().min() >= 4 and twin.abs().max() < 8
        # and against the one-max twin: the twins differ by the rounding of p,
        # at most 2^-8 of the output's size on positive V (test_torch_mla.py)
        one_max = A.paged_mla_decode_twin(qp, pool, tables, cd, S, scale, 512)
        rounding = 2.0 ** -8 * one_max.abs().max().item()
        assert (twin - one_max).abs().max().item() <= rounding
        assert (got.float() - one_max).abs().max().item() <= TOL + rounding
    else:
        plain = A.paged_mla_decode_plain(q, pool, tables, cd, S, scale, 512)
        assert (got.float() - plain.float()).abs().max().item() <= TOL
    part = A.paged_mla_decode_partial(q, used, tables, cd, S, scale, 512)
    want = A.paged_mla_decode_partial_plain(q, pool, tables, cd, S, scale, 512)
    assert _partial_err(part, want, np.array(ctx)) <= TOL
    norm = lambda p: p[2] / p[1].clamp_min(1e-20)[..., None]
    assert (norm(part) - norm(want))[live].abs().max().item() <= TOL
    # the fused mode: the lengths count the new row, written at row ctx - 1
    c1 = (cd - 1).clamp_min(0).long()
    slots = torch.where(cd >= 1, tables[torch.arange(8, device=cuda), c1 // S] * S + c1 % S,
                        -1).to(torch.int32)
    slots[3] = -1  # frozen
    new = _bf16(rng, cuda, 8, 576)
    if kind == "v6":
        new[:, :512] = _v6(rng, cuda, 8, 512)
    fk, fp = used.clone(), pool.clone()
    if kind == "nan":  # the written rows are NaN before the call
        fk = torch.full_like(pool, float("nan"))
        keep = _read_slots(tables, cd, 0, fused=True).to(cuda)
        fk[keep] = pool[keep]
    tail = (new, slots, tables, cd, S, scale, 512)
    got = PA.paged_mla_decode_fused(q, fk, *tail)
    want = PA.paged_mla_decode_fused_plain(qp, fp, *tail)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL
    wrote = (slots >= 0) & live
    assert torch.equal(fk[slots[wrote].long()], new[wrote])
    if kind != "nan":
        assert torch.equal(fk, fp)


@pytest.mark.cuda
def test_latent_decodes_back_to_back_at_other_split_counts(cuda):
    """Latent decodes (normal and partial) at three or more split counts,
    queued on one stream with the head-major decode between them and no
    synchronisation: each equals its twin or plain version, the head-major
    decode its plain version, and the head-major decode's tickets are zero
    afterwards."""
    rng = np.random.default_rng(21)
    scale = 1.0 / np.sqrt(192)
    calls = []
    for B, H, ctx_max in ((8, 16, 2816), (2, 16, 700), (8, 128, 2816), (1, 40, 300)):
        lens = np.full(B, ctx_max, np.int32)
        lens[B // 2:] = rng.integers(1, ctx_max, B - B // 2)
        q, pool, _, tables, cd = _latent_case(rng, cuda, lens, H, "plain")
        calls.append(((q, pool, tables, cd, S, scale), A.mla_plan(cuda, B, H, tables.shape[1] * S)))
    assert len({c[1] for c in calls}) >= 3
    hm_lens = _ctx(rng, 3712)
    hm_tables, hm_pages = _tables(rng, hm_lens, cuda)
    hm_args = (_bf16(rng, cuda, 8, 40, 128), _bf16(rng, cuda, 8, hm_pages * S, 256), hm_tables,
               torch.from_numpy(hm_lens).to(cuda), S, 1.0 / np.sqrt(128))
    got = []
    for args, _ in calls:
        got.append((A.paged_mla_decode(*args, v_dim=512), A.paged_mla_decode_partial(*args, 512)))
        got.append(A.paged_decode_attention_hm(*hm_args))
    torch.cuda.synchronize()
    assert not any(t.any() for t in A._TICKETS.values())
    hm_want = A.paged_decode_attention_hm_plain(*hm_args)
    for (args, _), (out, part), hm in zip(calls, got[::2], got[1::2]):
        assert (out.float() - A.paged_mla_decode_twin(*args, 512).float()).abs().max() <= TOL
        ctx = args[3].cpu().numpy()
        assert _partial_err(part, A.paged_mla_decode_partial_plain(*args, 512), ctx) <= TOL
        assert (hm.float() - hm_want.float()).abs().max().item() <= TOL


def _fp8_weights(rng, device, K, N):
    """e4m3 weights without the NaN bytes, block scales around 2/sqrt(K)/100."""
    bits = rng.integers(0, 256, (K, N)).astype(np.uint8)
    bits[(bits & 0x7F) == 0x7F] = 0x3C
    w = torch.from_numpy(bits).to(device).view(torch.float8_e4m3fn)
    bs = (rng.random((K // 128, N // 128)) + 0.5) * (0.02 / np.sqrt(K))
    return w, torch.from_numpy(bs.astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("M", [1, 7, 8, 16, 17, 32, 33, 512, 515])
@pytest.mark.parametrize("K,N", [(128, 128), (128, 4096), (384, 256), (4096, 1024), (4096, 4096),
                                 (4096, 12288), (12288, 4096)])  # the last four: Qwen3-8B
def test_fp8_block_matmul_matches_plain(cuda, dtype, M, K, N):
    rng = np.random.default_rng(M + K + N)
    w, bs = _fp8_weights(rng, cuda, K, N)
    x = _rand(dtype, rng, cuda, M, K)
    before = F8.fp8_block_matmul.launches
    got = F8.fp8_block_matmul(x, w, bs)
    assert F8.fp8_block_matmul.launches == before + 1
    want = F8.fp8_block_matmul_plain(x, w, bs)
    assert got.dtype == dtype and got.shape == (M, N) and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    assert err <= 1e-2, err
    # split-K adds its partial sums in a fixed order: a repeated call is bit-equal
    assert torch.equal(got, F8.fp8_block_matmul(x, w, bs))


# a TP=2 rank's row-parallel projections (K, N) and a column-parallel one:
# Qwen2.5-14B's o_proj and down_proj rows and q_proj columns (row 4),
# Qwen3-8B's (row 9)
TP_RANK_W4 = [(2560, 5120), (6912, 5120), (5120, 2560)]
TP_RANK_FP8 = [(2048, 4096), (6144, 4096), (4096, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16, 37, 512])
@pytest.mark.parametrize("K,N", TP_RANK_W4)
def test_w4a16_matmul_fp32_output_at_a_tp_rank(cuda, M, K, N):
    """The fp32-output mode (a row-parallel rank's partial product) at a
    TP=2 rank's shapes: fp32, within 1e-2 of the largest output of the plain
    version's fp32 product, and the same accumulators as the bf16 mode, which
    is that output rounded once."""
    rng = np.random.default_rng(M + K + N)
    w, scales, zeros = _int4(rng, K, N, 128, cuda, True)
    x = _bf16(rng, cuda, M, K)
    got = Q.w4a16_matmul(x, w, scales, zeros, out_dtype=torch.float32)
    want = Q.w4a16_matmul_plain(x, w, scales, zeros, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (M, N) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert torch.equal(got.to(torch.bfloat16), Q.w4a16_matmul(x, w, scales, zeros))


@pytest.mark.cuda
@pytest.mark.parametrize("M,cfg,splits", [(4, 0, 2), (4, 0, 3), (4, 0, 7), (4, 0, 20),
                                          (37, 1, 1), (37, 1, 7), (37, 2, 20), (130, 1, 40),
                                          (130, 2, 6), (130, 2, 8)])
def test_w4a16_matmul_fp32_output_split_k_edges(cuda, M, cfg, splits):
    """The fp32-output mode at Qwen2.5-14B's o_proj rows on a TP=2 rank (K
    2560, a group every 128 rows): the decode kernel at 2 to 20 splits of its
    20 stages, the prefill kernels at 1 to 40 of their 40, each held to the
    plain fp32 product, and its bf16 rounding equal to the bf16 mode's at the
    same plan."""
    rng = np.random.default_rng(splits + M)
    K, N = 2560, 5120
    w, scales, zeros = _int4(rng, K, N, 128, cuda, True)
    x = _bf16(rng, cuda, M, K)
    out = torch.empty(M, N, dtype=torch.float32, device=cuda)
    Q._run(x, w, scales, zeros, out, True, (cfg, splits))
    want = Q.w4a16_matmul_plain(x, w, scales, zeros, out_dtype=torch.float32)
    assert (out - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    half = torch.empty(M, N, dtype=torch.bfloat16, device=cuda)
    Q._run(x, w, scales, zeros, half, True, (cfg, splits))
    assert torch.equal(out.to(torch.bfloat16), half)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16, 17, 512])
@pytest.mark.parametrize("K,N", TP_RANK_FP8)
def test_fp8_block_matmul_fp32_output_at_a_tp_rank(cuda, M, K, N):
    """Row 9's fp32-output mode, in the split-K decode kernel (M <= 16) and
    the wgmma kernel, at a TP=2 rank's shapes: within 1e-2 of the largest
    output of the plain fp32 sum, and the same sums as the bf16 mode."""
    rng = np.random.default_rng(M + K + N)
    w, bs = _fp8_weights(rng, cuda, K, N)
    x = _bf16(rng, cuda, M, K)
    got = F8.fp8_block_matmul(x, w, bs, out_dtype=torch.float32)
    want = F8.fp8_block_matmul_plain(x, w, bs, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (M, N) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert torch.equal(got.to(torch.bfloat16), F8.fp8_block_matmul(x, w, bs))


@pytest.mark.cuda
@pytest.mark.parametrize("M,cfg,splits", [(4, 0, 2), (4, 0, 3), (4, 0, 6), (4, 0, 16),
                                          (37, 1, 1), (37, 1, 4), (37, 1, 16), (300, 1, 3)])
def test_fp8_block_matmul_fp32_output_split_k_edges(cuda, M, cfg, splits):
    """Row 9's fp32-output mode at Qwen3-8B's o_proj rows on a TP=2 rank (K
    2048, 16 K blocks) at split counts the plan may not pick (set in its
    plan cache), each held to the plain fp32 sum."""
    rng = np.random.default_rng(splits + M)
    K, N = 2048, 4096
    w, bs = _fp8_weights(rng, cuda, K, N)
    x = _bf16(rng, cuda, M, K)
    if x.device not in F8._DEVICES:
        F8._DEVICES[x.device] = F8.SplitScratch(x.device)
    dev = F8._DEVICES[x.device]
    kept = dev.plans.pop((M, N, K), None)
    dev.plans[M, N, K] = (cfg, splits)
    try:
        got = F8.fp8_block_matmul(x, w, bs, out_dtype=torch.float32)
        half = F8.fp8_block_matmul(x, w, bs)
    finally:
        dev.plans.pop((M, N, K))
        if kept is not None:
            dev.plans[M, N, K] = kept
    want = F8.fp8_block_matmul_plain(x, w, bs, out_dtype=torch.float32)
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert torch.equal(got.to(torch.bfloat16), half)


@pytest.mark.cuda
def test_fp32_output_modes_raise_on_other_dtypes(cuda):
    """The kernels write their dtype or fp32: any other output dtype raises,
    with no fallback."""
    rng = np.random.default_rng(0)
    w, scales, zeros = _int4(rng, 256, 64, 128, cuda, True)
    x = _bf16(rng, cuda, 4, 256)
    with pytest.raises(NotImplementedError, match="out_dtype"):
        Q.w4a16_matmul(x, w, scales, zeros, out_dtype=torch.float16)
    w8, bs = _fp8_weights(rng, cuda, 128, 128)
    with pytest.raises(NotImplementedError, match="out_dtype"):
        F8.fp8_block_matmul(_bf16(rng, cuda, 4, 128), w8, bs, out_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 512])
def test_fp8_block_matmul_is_exact_on_every_e4m3_code(cuda, M):
    """A [128, 256] weight holding every finite e4m3 code (the 254 bytes that
    are not 0x7f or 0xff, each twice) with unit block scales, against x rows
    that pick single weights (one-hot) and pairs: each output is one weight,
    or a sum of two, exactly representable in bf16 except where a pair
    rounds; the one-hot outputs must equal the codes' values bit for bit, the
    others the plain version within FP8_TOL."""
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint8)
    bits = np.concatenate([codes, codes[::-1]]).reshape(2, 254)
    w_np = np.zeros((128, 256), np.uint8)
    w_np[:2, :254] = bits
    w_np[2:, :] = np.random.default_rng(0).integers(0, 0x7F, (126, 256)).astype(np.uint8)
    w = torch.from_numpy(w_np).to(cuda).view(torch.float8_e4m3fn)
    bs = torch.ones(1, 2, device=cuda)
    x = torch.zeros(M, 128, device=cuda, dtype=torch.bfloat16)
    x[0, 0] = 1.0  # row 0 picks weight row 0
    x[1, 1] = 1.0  # row 1 picks weight row 1
    x[2:, 2:] = _bf16(np.random.default_rng(1), cuda, M - 2, 126)
    got = F8.fp8_block_matmul(x, w, bs)
    want = F8.fp8_block_matmul_plain(x, w, bs)
    exact = w[:2].float().to(torch.bfloat16)
    assert torch.equal(got[:2], exact) and torch.equal(want[:2], exact)
    assert exact.isfinite().all() and exact.unique().numel() == 253  # +0 and -0 compare equal
    err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    assert err <= 1e-2


@pytest.mark.cuda
def test_fp8_linear_on_gpu_dispatch(cuda):
    """A bf16 or fp32 x over 128 x 128 blocks launches the kernel (fp32 cast to
    bf16 and back); other block shapes and per-channel scales dequantize; the
    wrapper itself raises on what the kernel does not take."""
    rng = np.random.default_rng(0)
    K, N = 256, 384
    w, bs = _fp8_weights(rng, cuda, K, N)
    x = _bf16(rng, cuda, 2, 5, K)
    n0 = F8.fp8_block_matmul.launches
    y = fp8_linear({"w_f8": w, "block_scale": bs}, x)
    y32 = fp8_linear({"w_f8": w, "block_scale": bs}, x.float())
    assert F8.fp8_block_matmul.launches == n0 + 2
    assert y.shape == (2, 5, N) and y.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(y32, y.float())
    want = F8.fp8_block_matmul_plain(x, w, bs)
    assert (y.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
    # 64-row blocks and a per-channel scale: dequantize, no launch
    bs64 = bs.repeat_interleave(2, dim=0)
    y64 = fp8_linear({"w_f8": w, "block_scale": bs64}, x)
    ych = fp8_linear({"w_f8": w, "scale": torch.full((N,), 0.01, device=cuda)}, x)
    assert F8.fp8_block_matmul.launches == n0 + 2
    assert (y64.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
    assert torch.isfinite(ych).all()
    with pytest.raises(NotImplementedError, match="bf16"):
        F8.fp8_block_matmul(x.float(), w, bs)
    with pytest.raises(ValueError, match="block_scale"):
        F8.fp8_block_matmul(x, w, bs[:1])
    with pytest.raises(ValueError, match="contiguous"):
        F8.fp8_block_matmul(x.transpose(0, 1), w, bs)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        F8.fp8_block_matmul(x, w.view(torch.uint8), bs)


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("M", [1, 8, 16, 40, 512])
def test_int8_linear_on_gpu_matches_cpu(cuda, M, smooth):
    """M below 32 goes through the zero-padded torch._int_mm."""
    rng = np.random.default_rng(M)
    K, N = 2304, 5760
    w_q, scale = quantize_int8_weight(torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) / 48)
    p = {"w_q": w_q, "scale": scale}
    if smooth:
        p["smooth"] = torch.from_numpy((rng.random(K) + 0.5).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    want = int8_linear(p, x).float()
    got = int8_linear({k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert (got.float().cpu() - want).abs().max().item() <= 1e-2 * want.abs().max().item()


# ---------------------------------------------------------------------------
# slot-major pools (head_dim 16, 80, 96, 100; 128 under ZT_NO_PACKED_KV=1)
# ---------------------------------------------------------------------------

def _slot_major_pools(rng, device, slots, hkv, D, int8, dtype=torch.bfloat16):
    """Separate K and V pools [1, N, Hkv, D] of unit-variance rows (bf16 or
    ``dtype``), or those rows quantized with their head-major scales [Hkv, N + 1]."""
    k, v = _rand(dtype, rng, device, slots, hkv, D), _rand(dtype, rng, device, slots, hkv, D)
    if not int8:
        return k[None], v[None]
    (k_q, k_s), (v_q, v_s) = _quantize_rows(k), _quantize_rows(v)
    pad = torch.zeros(hkv, 1, device=device)
    return (k_q[None], v_q[None], torch.cat([k_s.t(), pad], 1).contiguous(),
            torch.cat([v_s.t(), pad], 1).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("D", [16, 80, 96, 100, 128])
def test_slot_major_decode_attention_matches_plain(cuda, dtype, D, G, int8):
    """8 sequences on 2 KV heads: contexts ending mid-page, an empty slot,
    then the same with a sliding window shorter than the contexts."""
    rng = np.random.default_rng(D + G)
    hkv = 2
    ctx = np.array([700, 1, 0, 17, 33, 257, 16, 129], np.int32)
    tables, npages = _tables(rng, ctx, cuda)
    pools = _slot_major_pools(rng, cuda, npages * S, hkv, D, int8, dtype)
    fn, plain = ((PA.paged_decode_attention_q, PA.paged_decode_attention_q_plain) if int8
                 else (PA.paged_decode_attention, PA.paged_decode_attention_plain))
    q = _rand(dtype, rng, cuda, len(ctx), hkv * G, D)
    for window in (0, 40):
        args = (q, *pools, tables, torch.from_numpy(ctx).to(cuda), S, 1.0 / np.sqrt(D), window)
        got, want = fn(*args), plain(*args)
        assert torch.equal(got[2], torch.zeros_like(got[2]))
        assert (got.float() - want.float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("hkv,G,D", [(8, 4, 80), (8, 5, 128), (4, 16, 80), (1, 24, 64)])
def test_slot_major_decode_attention_long_context_and_wide_groups(cuda, hkv, G, D, window, int8):
    """H2O-Danube-1.8B's geometry (8 KV heads, G 4, head_dim 80) and
    Qwen2.5-14B's heads (G 5 of 128) at batch 8, contexts up to 3712 (the
    kernel cuts the context into ranges and merges them), one slot empty;
    G 24: query heads past the kernel's 16 rows a block."""
    rng = np.random.default_rng(hkv * G + window)
    ctx = np.array([3712, 7, 0, 1500, 100, 16, 250, 3201], np.int32)
    tables, npages = _tables(rng, ctx, cuda)
    pools = _slot_major_pools(rng, cuda, npages * S, hkv, D, int8)
    fn, plain = ((PA.paged_decode_attention_q, PA.paged_decode_attention_q_plain) if int8
                 else (PA.paged_decode_attention, PA.paged_decode_attention_plain))
    args = (_bf16(rng, cuda, 8, hkv * G, D), *pools, tables, torch.from_numpy(ctx).to(cuda), S,
            1.0 / np.sqrt(D), window)
    got = fn(*args)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert (got.float() - plain(*args).float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hkv,D", [(8, 80), (8, 128), (2, 16), (1, 100), (3, 7)])
@pytest.mark.parametrize("start,n", [(0, 8), (21, 40), (3205, 512)])
def test_slot_major_writes_are_exact(cuda, start, n, hkv, D, int8):
    """The pair write (the counterpart of both of the reference's slot-major
    writes) against its plain version: a decode step's rows or a chunk
    starting mid-page through a shuffled table, one row skipped."""
    rng = np.random.default_rng(start + D)
    pages = (start + n) // S + 3
    table = rng.permutation(pages)
    pos = np.arange(start, start + n)
    slots = torch.from_numpy((table[pos // S] * S + pos % S).astype(np.int32)).to(cuda)
    slots[n // 3] = -1
    if int8:
        rows = [torch.from_numpy(rng.integers(-127, 128, (n, hkv, D)).astype(np.int8)).to(cuda)
                for _ in range(2)]
        pools = [torch.from_numpy(rng.integers(-127, 128, (1, pages * S, hkv, D)).astype(np.int8)
                                  ).to(cuda) for _ in range(2)]
    else:
        rows = [_bf16(rng, cuda, n, hkv, D) for _ in range(2)]
        pools = [_bf16(rng, cuda, 1, pages * S, hkv, D) for _ in range(2)]
    n0 = W.write_rows_pair.launches
    gk, gv = W.write_rows_pair(*(p.clone() for p in pools), *rows, slots)
    wk, wv = W.write_rows_pair_plain(*(p.clone() for p in pools), *rows, slots)
    assert W.write_rows_pair.launches == n0 + 1
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_slot_major_write_kv_routes_as_the_reference(cuda, quantized, monkeypatch):
    """write_kv on the card over slot-major pools, head_dim 80 and 128 (under
    ZT_NO_PACKED_KV=1, where the reference takes paged_write_rows), goes
    through the one copy wrapper; int8 rows through the same kernel, scales
    beside them. Both layouts' per-step writes (rope_write_kv) take their
    prologue: rope_write_rows_pair over slot-major pools, rope_write_rows_hm
    over the packed pool, one launch, bit-equal to rope + write_kv."""
    rng = np.random.default_rng(6)
    for D, no_packed in ((80, "1"), (128, "1"), (128, "0")):
        monkeypatch.setenv("ZT_NO_PACKED_KV", no_packed)
        cache = new_kv_cache(1, 8, S, 8, D, torch.bfloat16, quantized=quantized, device=cuda)
        assert cache.packed == (no_packed == "0")
        k, v = _bf16(rng, cuda, 5, 8, D), _bf16(rng, cuda, 5, 8, D)
        slots = torch.tensor([3, 40, -1, 77, 100], dtype=torch.int32, device=cuda)
        keep = slots >= 0
        if not cache.packed:
            n0 = W.write_rows_pair.launches
            write_kv(cache, 0, k, v, slots)
            assert W.write_rows_pair.launches == n0 + 1
            if quantized:
                (k_q, k_s), (v_q, v_s) = _quantize_rows(k), _quantize_rows(v)
                assert torch.equal(cache.k[0][0, slots[keep].long()], k_q[keep])
                assert torch.equal(cache.v[0][0, slots[keep].long()], v_q[keep])
                assert torch.equal(cache.k_scale[0][:, slots[keep].long()], k_s[keep].t())
            else:
                assert torch.equal(cache.k[0][0, slots[keep].long()], k[keep])
                assert torch.equal(cache.v[0][0, slots[keep].long()], v[keep])
        # the per-step write: the prologue against rope + write_kv on a second cache
        q = _bf16(rng, cuda, 5, 32, D)
        cos, sin = _rope_tables(rng, 5, D, True, cuda)
        twin = new_kv_cache(1, 8, S, 8, D, torch.bfloat16, quantized=quantized, device=cuda)
        prologue = W.rope_write_rows_hm if cache.packed else W.rope_write_rows_pair
        n0, c0 = prologue.launches, W.write_rows_pair.launches
        got = rope_write_kv(cache, 0, q, k, v, cos, sin, True, slots)
        assert prologue.launches == n0 + 1 and W.write_rows_pair.launches == c0
        want = apply_rope_rot(q, cos, sin, True)
        write_kv(twin, 0, apply_rope_rot(k, cos, sin, True), v, slots)
        assert torch.equal(got, want)
        # one skipped row: the spare scale column holds its scales on both sides
        assert all(torch.equal(a[0], b[0]) for a, b in zip(cache.arrays(), twin.arrays()))


@pytest.mark.cuda
def test_slot_major_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    q = torch.zeros(2, 4, 80, dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros(1, 64, 2, 80, dtype=torch.bfloat16, device=cuda)
    pool8 = pool.to(torch.int8)
    sc = torch.zeros(2, 65, device=cuda)
    tables = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        PA.paged_decode_attention(q.float(), pool, pool, tables, ctx, S, 0.1)       # fp32 q
    with pytest.raises(NotImplementedError):
        PA.paged_decode_attention(q, pool8, pool8, tables, ctx, S, 0.1)             # int8 pools
    with pytest.raises(NotImplementedError):
        PA.paged_decode_attention_q(q, pool, pool, sc, sc, tables, ctx, S, 0.1)     # bf16 pools
    with pytest.raises(ValueError):
        PA.paged_decode_attention_q(q, pool8, pool8, sc[:, :10], sc, tables, ctx, S, 0.1)
    wide = torch.zeros(2, 4, 272, dtype=torch.bfloat16, device=cuda)
    wpool = torch.zeros(1, 64, 2, 272, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        PA.paged_decode_attention(wide, wpool, wpool, tables, ctx, S, 0.1)          # D > 256
    rows = torch.zeros(3, 2, 80, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        W.write_rows_pair(pool, pool, rows, rows, torch.zeros(3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        W.write_rows_pair(pool, pool, rows[:, :1], rows, torch.zeros(3, dtype=torch.int32,
                                                                       device=cuda))


# the slot-major decode's split edges at H2O-Danube-1.8B's heads and batch
# (one wave is 6 splits on an H100: 768 tokens are 12 tiles, 2 a split, every
# split full; 769 leaves one token for a seventh tile), contexts 1, 64, 65 and
# an empty slot
_SLOT_EDGE_CTX = [3712, 1, 0, 64, 65, 768, 769, 2000]


def _v6(rng, device, *shape):
    """V rows near 6 (uniform in [4.5, 7.5)): outputs in [4, 8), where one
    bf16 ulp (2^-5) is above the tolerance, so probabilities rounded to bf16
    before P.V would show."""
    x = 6 + 1.5 * (2 * rng.random(shape) - 1)
    return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)


def _read_slots(tables, ctx, window, fused=False):
    """Pool slots that some sequence attends to: tokens [start, end) of each
    (end = ctx - 1 in the fused mode)."""
    tables, ctx = tables.cpu().numpy(), ctx.cpu().numpy()
    keep = [np.zeros(0, np.int64)]
    for b, c in enumerate(ctx):
        t = np.arange(max(0, c - window) if window else 0, max(c - 1, 0) if fused else c)
        keep.append(tables[b, t // S].astype(np.int64) * S + t % S)
    return torch.from_numpy(np.concatenate(keep))


def _poisoned(pools, keep, int8):
    """The pools [1, N, Hkv, X] with NaN in every row but ``keep`` (int8 pools:
    their scales [Hkv, >= N] NaN in every other column)."""
    out = list(pools)
    idx = keep.to(pools[0].device)
    for i in ((2, 3) if int8 else range(len(pools))):
        bad = torch.full_like(pools[i], float("nan"))
        if int8:
            bad[:, idx] = pools[i][:, idx]
        else:
            bad[0, idx] = pools[i][0, idx]
        out[i] = bad
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 40])  # 40: windows that start mid-tile
@pytest.mark.parametrize("hkv,G,D", [(8, 4, 80), (2, 2, 192), (2, 2, 256), (2, 3, 7), (2, 5, 33)])
def test_slot_major_decode_attention_edges(cuda, hkv, G, D, window, int8):
    """Danube's heads at the split edges, and head_dim 192, 256 and odd ones,
    each three ways: unit-variance rows; pools holding NaN in every row that
    no sequence attends to (the output finite and equal to the plain version's
    over the clean pools); V rows near 6 (outputs in [4, 8), held against the
    plain version's fp32 output: p is not rounded)."""
    rng = np.random.default_rng(hkv * G + D + window)
    ctx = torch.from_numpy(np.array(_SLOT_EDGE_CTX, np.int32)).to(cuda)
    tables, npages = _tables(rng, _SLOT_EDGE_CTX, cuda)
    fn, plain = ((PA.paged_decode_attention_q, PA.paged_decode_attention_q_plain) if int8
                 else (PA.paged_decode_attention, PA.paged_decode_attention_plain))
    q = _bf16(rng, cuda, 8, hkv * G, D)
    tail = (tables, ctx, S, 1.0 / np.sqrt(D), window)
    pools = _slot_major_pools(rng, cuda, npages * S, hkv, D, int8)
    want = plain(q, *pools, *tail)
    for kind, got in (("plain", fn(q, *pools, *tail)),
                      ("nan", fn(q, *_poisoned(pools, _read_slots(tables, ctx, window), int8),
                                 *tail))):
        assert torch.isfinite(got).all(), kind
        assert torch.equal(got[2], torch.zeros_like(got[2])), kind
        assert (got.float() - want.float()).abs().max().item() <= TOL, kind
    if int8:
        (v_q, v_s) = _quantize_rows(_v6(rng, cuda, npages * S, hkv, D))
        v6 = (pools[0], v_q[None], pools[2],
              torch.cat([v_s.t(), torch.zeros(hkv, 1, device=cuda)], 1).contiguous())
    else:
        v6 = (pools[0], _v6(rng, cuda, 1, npages * S, hkv, D))
    # against the plain version's fp32 output, before its one rounding to
    # bf16: two roundings of close fp32 values may differ by a whole ulp
    got, want = fn(q, *v6, *tail), plain(q.float(), *v6, *tail)
    live = ctx > 0
    assert want[live].float().abs().min() >= 4 and want.float().abs().max() < 8
    assert (got.float() - want.float()).abs().max().item() <= TOL


@pytest.mark.cuda
def test_split_decodes_back_to_back_share_the_tickets(cuda):
    """Slot-major decodes (bf16, int8, fused) whose split counts differ,
    queued on one stream with the head-major decode between them and no
    synchronisation: each equals its plain version and the tickets that all
    of them share are zero afterwards."""
    rng = np.random.default_rng(12)
    calls = []
    for B, ctx_max, int8 in ((8, 3712, False), (2, 300, True), (1, 100, False), (8, 2000, True)):
        lens = _ctx(rng, ctx_max, B) if B > 2 else np.full(B, ctx_max, np.int32)
        tables, npages = _tables(rng, lens, cuda)
        pools = _slot_major_pools(rng, cuda, npages * S, 8, 80, int8)
        args = (_bf16(rng, cuda, B, 32, 80), *pools, tables, torch.from_numpy(lens).to(cuda), S,
                1.0 / np.sqrt(80))
        fn, plain = ((PA.paged_decode_attention_q, PA.paged_decode_attention_q_plain) if int8
                     else (PA.paged_decode_attention, PA.paged_decode_attention_plain))
        lib = "paged_attention_q" if int8 else "paged_attention"
        calls.append((fn, plain, args, A.decode_splits(B, 8, 4, tables.shape[1] * S,
                                                       A._capacity(cuda, 80, lib))))
    assert len({c[3] for c in calls}) >= 3
    hm_lens = _ctx(rng, 3712)
    hm_tables, hm_pages = _tables(rng, hm_lens, cuda)
    hm_args = (_bf16(rng, cuda, 8, 40, 128), _bf16(rng, cuda, 8, hm_pages * S, 256), hm_tables,
               torch.from_numpy(hm_lens).to(cuda), S, 1.0 / np.sqrt(128))
    f_tables, f_pages, f_slots, f_ctx = _fused_inputs(rng, cuda, _FUSED_CTX)
    f_pools = [_bf16(rng, cuda, 1, f_pages * S, 8, 80) for _ in range(2)]
    f_rows = [_bf16(rng, cuda, 8, 8, 80) for _ in range(2)]
    f_q = _bf16(rng, cuda, 8, 32, 80)
    f_want_pools = [p.clone() for p in f_pools]
    got = []
    for fn, _, args, _ in calls:
        got.append(fn(*args))
        got.append(A.paged_decode_attention_hm(*hm_args))
    f_got = PA.paged_decode_attention_fused(f_q, *f_pools, *f_rows, f_slots, f_tables, f_ctx, S,
                                            1.0 / np.sqrt(80))
    torch.cuda.synchronize()
    assert not any(t.any() for t in A._TICKETS.values())
    hm_want = A.paged_decode_attention_hm_plain(*hm_args)
    for (_, plain, args, _), out, hm in zip(calls, got[::2], got[1::2]):
        assert (out.float() - plain(*args).float()).abs().max().item() <= TOL
        assert (hm.float() - hm_want.float()).abs().max().item() <= TOL
    f_want = PA.paged_decode_attention_fused_plain(f_q, *f_want_pools, *f_rows, f_slots,
                                                   f_tables, f_ctx, S, 1.0 / np.sqrt(80))
    assert (f_got.float() - f_want.float()).abs().max().item() <= TOL
    assert all(torch.equal(g, w) for g, w in zip(f_pools, f_want_pools))


# ---------------------------------------------------------------------------
# window side-KV: partial modes of the decode kernels, the two flushes
# ---------------------------------------------------------------------------

def _partial_err(got, want, ctx):
    """Largest of: |m| error where l > 0, l and acc errors over their largest
    plain value. An empty context must give exactly (-2e38, 0, 0)."""
    (m, l, acc), (wm, wl, wacc) = got, want
    live = wl > 0
    empty = torch.from_numpy(ctx == 0).to(m.device)
    assert torch.all(m[empty] == -2e38) and not l[empty].any() and not acc[empty].any()
    assert all(torch.isfinite(t).all() for t in (l, acc))
    return max((m[live] - wm[live]).abs().max().item(),
               ((l - wl).abs().max() / wl.abs().max()).item(),
               ((acc - wacc).abs().max() / wacc.abs().max()).item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,hq,hkv,D,ctx", [
    (16, 36, 36, 64, None),                                   # MiniCPM-2B, context 512
    (8, 40, 8, 128, [3712, 7, 513, 0, 1500, 100, 16, 250]),  # Qwen2.5-14B
    (8, 40, 8, 128, _SPLIT_CTX),                              # the bf16 kernel's split edges
    (8, 16, 4, 192, _SPLIT_CTX), (8, 32, 2, 256, _SPLIT_CTX), (8, 32, 2, 128, _SPLIT_CTX),
    (8, 16, 8, 256, [3712, 7, 513, 0, 1500, 100, 16, 250]),  # Gemma-2-9B's heads
])
def test_decode_attention_partial_matches_plain(cuda, dtype, B, hq, hkv, D, ctx, int8):
    """The partial modes against their plain versions, the int8 one at every
    head dim and group since its redesign."""
    rng = np.random.default_rng(B + D)
    ctx = np.array(ctx if ctx else [512] * 5 + [0] + [512] * 10, np.int32)
    tables, npages = _tables(rng, ctx, cuda)
    pools = _int8_pool(rng, cuda, hkv, npages * S, D) if int8 else (
        _rand(dtype, rng, cuda, hkv, npages * S, 2 * D),)
    args = (_rand(dtype, rng, cuda, B, hq, D), *pools, tables, torch.from_numpy(ctx).to(cuda), S,
            1.0 / np.sqrt(D))
    fn, plain = ((A.paged_decode_attention_hm_q_partial, A.paged_decode_attention_hm_q_partial_plain)
                 if int8 else
                 (A.paged_decode_attention_hm_partial, A.paged_decode_attention_hm_partial_plain))
    before = fn.launches
    got = (A.paged_decode_attention_hm_q if int8 else A.paged_decode_attention_hm)(
        *args, emit_partial=True)
    assert fn.launches == before + 1
    assert got[0].shape == (B, hkv, hq // hkv) and got[2].shape == (B, hkv, hq // hkv, D)
    assert _partial_err(got, plain(*args), ctx) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_mla_decode_partial_matches_plain(cuda, dtype):
    rng = np.random.default_rng(5)
    ctx = np.array([2816, 7, 0, 1500, 100, 16, 1, 2305], np.int32)  # DeepSeek-V2-Lite's batch
    tables, npages = _tables(rng, ctx, cuda)
    args = (_rand(dtype, rng, cuda, 8, 16, 576), _rand(dtype, rng, cuda, npages * S, 576), tables,
            torch.from_numpy(ctx).to(cuda), S, 1.0 / np.sqrt(192))
    got = A.paged_mla_decode(*args, v_dim=512, emit_partial=True)
    assert got[0].shape == (8, 16) and got[2].shape == (8, 16, 512)
    assert _partial_err(got, A.paged_mla_decode_partial_plain(*args, v_dim=512), ctx) <= TOL
    # normalizing the partials gives the normal mode's output
    out = A.paged_mla_decode(*args, v_dim=512)
    norm = got[2] / got[1].clamp_min(1e-20)[..., None]
    assert (norm - out.float()).abs().max().item() <= TOL


# windows: entries mid-page, on a page boundary, on a page's last row; n_rows
# 0, some and all of Kw 8, runs crossing into the next page (page size 16)
_ENTRY = [13, 16, 15, 3, 40, 31, 0, 57]
_N_ROWS = [8, 0, 4, 8, 1, 8, 5, 7]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,X,dtype", [
    (16, 36, 128, torch.bfloat16), (16, 36, 128, torch.int8),  # MiniCPM-2B's pool
    (8, 8, 256, torch.bfloat16), (8, 8, 256, torch.int8),      # Qwen2.5-14B's
    (8, 0, 576, torch.bfloat16),                               # DeepSeek-V2-Lite's latent pool
])
def test_flush_side_rows_is_exact(cuda, B, H, X, dtype):
    rng = np.random.default_rng(B + X)
    entry = np.array((_ENTRY * 2)[:B], np.int32)
    n_rows = np.array((_N_ROWS * 2)[:B], np.int32)
    n_rows[-1] = 0  # an idle slot
    tables, npages = _tables(rng, entry + 8, cuda)
    lead = (H,) if H else ()

    def rand(*shape):
        if dtype == torch.int8:
            return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(cuda)
        return _bf16(rng, cuda, *shape)

    pool = rand(*lead, npages * S, X)
    side = rand(B, *lead, 8, X)
    fn, plain = ((W.flush_side_rows_hm, W.flush_side_rows_hm_plain) if H else
                 (W.flush_side_rows_2d, W.flush_side_rows_2d_plain))
    i32 = lambda a: torch.from_numpy(a).to(cuda)
    before = fn.launches
    got = fn(pool.clone(), side, i32(entry), i32(n_rows), tables, S)
    want = plain(pool.clone(), side, i32(entry), i32(n_rows), tables, S)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, want) and not torch.equal(got, pool)


def _layered_flush_case(rng, device, L_, B, H, X, Kw, kind):
    """L layers' pools and side rows for the layered flush: windows of Kw
    rows from _ENTRY (mid-page, on a page boundary, crossing one), _N_ROWS
    live (0: a dead slot; the last slot idle); int8 pools with their scale
    arrays (-1 everywhere, so a column written shows) and fp32 side rows."""
    entry = np.array((_ENTRY * 2)[:B], np.int32)
    n_rows = np.minimum(np.array((_N_ROWS * 2)[:B], np.int32), Kw)
    n_rows[-1] = 0
    tables, npages = _tables(rng, entry + Kw, device)
    N, lead = npages * S, ((H,) if H else (1,))
    if kind == "int8":
        pools = [torch.from_numpy(rng.integers(-127, 128, (*lead, N, X)).astype(np.int8)).to(device)
                 for _ in range(L_)]
        scales = [[torch.full((H, N + 1), -1.0, device=device) for _ in range(L_)] for _ in "kv"]
        side = torch.from_numpy(rng.standard_normal((L_, B, H, Kw, X)).astype(np.float32)).to(device)
        side[:, 0, 0, 0] = 0.0  # an all-zero row: the 1e-8 scale floor
    else:
        dtype = torch.float16 if kind == "fp16" else torch.bfloat16
        pools = [_rand(dtype, rng, device, *lead, N, X) for _ in range(L_)]
        scales = [None, None]
        side = _rand(dtype, rng, device, L_, B, *((H,) if H else ()), Kw, X)
    i32 = lambda a: torch.from_numpy(a).to(device)
    return pools, scales, side, (i32(entry), i32(n_rows), tables, S)


@pytest.mark.cuda
@pytest.mark.parametrize("L_,B,H,X,Kw,kind", [
    (40, 16, 36, 128, 8, "bf16"),       # MiniCPM-2B's window
    (3, 8, 8, 256, 8, "fp16"),
    (48, 8, 8, 256, 8, "int8"),         # Qwen2.5-14B's int8 window
    (3, 16, 36, 128, 8, "int8"), (2, 8, 2, 512, 16, "int8"),  # head_dim 256; Kw = the page
    (27, 8, 0, 576, 8, "bf16"),         # DeepSeek-V2-Lite's latent window
    (2, 8, 0, 576, 16, "fp16"), (2, 8, 8, 128, 16, "bf16"),
])
def test_flush_side_layers_is_exact(cuda, L_, B, H, X, Kw, kind):
    """The layered flush (one launch for every layer; over int8 pools the
    requantization and the scale scatter in it) bit-exact against its plain
    version: pools, and the scales of the live rows; a dead row writes no
    scale, so the spare column and every other column stay -1."""
    rng = np.random.default_rng(L_ + B + X + Kw)
    pools, (ks, vs), side, args = _layered_flush_case(rng, cuda, L_, B, H, X, Kw, kind)
    fn, plain = ((W.flush_side_layers_hm, W.flush_side_layers_hm_plain) if H else
                 (W.flush_side_layers_2d, W.flush_side_layers_2d_plain))
    got = [p.clone() for p in pools]
    want = [p.clone() for p in pools]
    extra = lambda sc: () if sc is None else tuple([t.clone() for t in a] for a in sc)
    got_sc, want_sc = extra(ks and (ks, vs)), extra(ks and (ks, vs))
    before = fn.launches
    fn(got, side, *args, *got_sc)
    plain(want, side, *args, *want_sc)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], pools[0]) and not torch.equal(got[-1], pools[-1])
    for g, w in zip(sum(got_sc, []), sum(want_sc, [])):
        assert torch.equal(g, w) and (g[:, -1] == -1).all()
    if kind == "int8":
        written = got_sc[0][0][:, :-1] != -1
        assert written.sum().item() == H * int(args[1].sum().item())
        assert (got_sc[0][0][:, :-1][written] >= 1e-8).all()


@pytest.mark.cuda
def test_flush_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    rng = np.random.default_rng(3)
    pools, (ks, vs), side, args = _layered_flush_case(rng, cuda, 2, 8, 2, 128, 8, "int8")
    with pytest.raises(NotImplementedError, match="fp32 rows"):  # requantizing from bf16 rows
        W.flush_side_layers_hm(pools, side.to(torch.bfloat16), *args, ks, vs)
    with pytest.raises(ValueError, match="scale"):  # one layer's scales missing
        W.flush_side_layers_hm(pools, side, *args, ks[:1], vs)
    with pytest.raises(ValueError, match="pools"):  # a pool short of the side rows' layers
        W.flush_side_layers_hm(pools[:1], side, *args, ks[:1], vs[:1])
    with pytest.raises(ValueError, match="int8"):  # int8 pools without scales: int8 rows only
        W.flush_side_layers_hm(pools, side, *args)


@pytest.mark.cuda
def test_kernels_raise_on_float32_and_mixed_dtypes(cuda):
    """The wrappers take bf16 or fp16, one type for q, rows and a model-dtype
    pool: float32 and a bf16/fp16 mix raise (no cast, no plain fallback)."""
    rng = np.random.default_rng(4)
    ctx = torch.tensor([40, 7], dtype=torch.int32, device=cuda)
    tables, npages = _tables(rng, [40, 7], cuda)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    q = lambda dt, *shape: _rand(dt, rng, cuda, *shape)
    for qd, pd in ((f32, f32), (f16, bf), (bf, f16)):
        with pytest.raises(NotImplementedError, match="bf16 or fp16"):
            A.paged_decode_attention_hm(q(qd, 2, 8, 128), q(pd, 2, npages * S, 256), tables, ctx,
                                        S, 0.1)
        with pytest.raises(NotImplementedError, match="bf16 or fp16"):
            PA.paged_decode_attention(q(qd, 2, 8, 80), q(pd, 1, npages * S, 2, 80),
                                      q(pd, 1, npages * S, 2, 80), tables, ctx, S, 0.1)
        with pytest.raises(NotImplementedError, match="bf16 or fp16"):
            P.paged_prefill_attention_hm_packed(q(qd, 16, 8, 128), q(pd, 2, npages * S, 256),
                                                tables[:1], ctx[:1], ctx[:1] * 0 + 16, S, 0.1)
        with pytest.raises(NotImplementedError, match="bf16 or fp16"):
            A.paged_mla_decode(q(qd, 2, 16, 576), q(pd, npages * S, 576), tables, ctx, S, 0.1,
                               v_dim=512)
    pool8, k_s, v_s = _int8_pool(rng, cuda, 2, npages * S, 128)
    with pytest.raises(NotImplementedError, match="bf16 or fp16"):
        A.paged_decode_attention_hm_q(q(f32, 2, 8, 128), pool8, k_s, v_s, tables, ctx, S, 0.1)
    w, scales, zeros = _int4(rng, 256, 128, 128, cuda, True)
    with pytest.raises(NotImplementedError, match="bf16 or fp16"):
        Q.w4a16_matmul(q(f32, 8, 256), w, scales, zeros)
    cos, sin = _rope_tables(rng, 4, 128, True, cuda)
    slots = torch.arange(4, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="bf16 or fp16"):  # fp16 rows into a bf16 pool
        W.rope_write_rows_hm(q(bf, 2, 64, 256), q(f16, 4, 8, 128), q(f16, 4, 2, 128),
                             q(f16, 4, 2, 128), cos, sin, True, slots)


def _fp16_config(layout):
    """A 2-layer fp16 model for each pool layout: packed head-major (head_dim
    64, bf16-layout pool in fp16; int8), slot-major (head_dim 80), and an MLA
    model's latent pool (DeepSeek's 512 + 64 latent rows)."""
    base = dict(model_type="llama", num_layers=2, dim_model=256, num_heads=4, dim_head=64,
                num_kv_heads=2, dim_ff=512, vocab_size=128, dtype="float16")
    if layout == "slot_major":
        base.update(dim_head=80)
    if layout == "latent":
        from zhilight_tpu_torch.config import MLAConfig

        base.update(model_type="deepseek_v2", num_kv_heads=4, dim_head=96,
                    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=32, qk_rope_head_dim=64,
                                  v_head_dim=32))
    return L.ModelConfig(**base)


def _forced_logits(ex, prompts, steps, feed=None):
    """Each prompt prefilled (one chunk) into a fresh cache of ``ex``'s pool
    kind, then ``steps`` decode steps of the batch, each fed the previous
    step's argmax (the first: the prefill's), or with ``feed`` the tokens
    ``feed[k]`` at step k. Returns the decode steps' fp32 logits [B, V], on
    the CPU, and the tokens each step was fed."""
    cfg, B = ex.cfg, len(prompts)
    i32 = dict(dtype=torch.int32, device=ex.device)
    maxp = max(len(p) + steps for p in prompts) // S + 1
    cache = ex.new_cache(B * maxp)
    tables = torch.arange(B * maxp, **i32).reshape(B, maxp)
    slots = lambda b, pos: (tables[b, (pos // S).long()] * S + pos % S).to(torch.int32)
    out, fed, first = [], [], []
    with torch.no_grad():
        for b, p in enumerate(prompts):
            pos = torch.arange(len(p), **i32)
            meta = PrefillMeta(positions=pos, slot_mapping=slots(b, pos), page_table=tables[b],
                               cache_len=torch.tensor(0, **i32), q_len=torch.tensor(len(p), **i32))
            logits, cache = L.forward_prefill(ex.params, cfg, ex.rope, torch.tensor(p, **i32),
                                              meta, cache)
            first.append(int(logits.argmax()))
        n = torch.tensor([len(p) for p in prompts], **i32)
        rows = torch.arange(B, device=ex.device)
        tokens = torch.tensor(first, **i32)
        for k in range(steps):
            if feed is not None:
                tokens = torch.tensor(feed[k], **i32)
            fed.append(tokens.tolist())
            pos = n + k
            meta = DecodeMeta(positions=pos, slot_mapping=slots(rows, pos), page_tables=tables,
                              context_lens=pos + 1)
            logits, cache = L.forward_decode(ex.params, cfg, ex.rope, tokens, meta, cache)
            out.append(logits.float().cpu())
            tokens = logits.argmax(-1).to(torch.int32)
    return out, fed


# what each fp16 layout's decode must launch (prefill: the prologue and, on
# head-major pools, the prefill kernel)
FP16_PATHS = {
    "packed": (W.rope_write_rows_hm, P.paged_prefill_attention_hm_packed,
               A.paged_decode_attention_hm),
    "int8": (W.rope_write_rows_hm, P.paged_prefill_attention_hm_packed_q,
             A.paged_decode_attention_hm_q),
    "slot_major": (W.rope_write_rows_pair, PA.paged_decode_attention),
    "latent": (W.rope_write_rows_2d, A.paged_mla_decode),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(FP16_PATHS))
def test_fp16_engine_on_gpu(cuda, layout):
    """An fp16 model served on the card on each pool layout: the pool is fp16
    (or int8), every kernel of the path launches and no wrapper raises, and
    each request gets its tokens. Then teacher-forced against the plain path
    (the same weights on the CPU, where every wrapper takes its plain
    version; both fed the card's greedy tokens, 12 decode steps): every
    step's logits within FP16_LOGIT_TOL of the row's largest, and the same
    argmax wherever the card's top-2 gap exceeds twice the largest
    difference."""
    cfg = _fp16_config(layout)
    cache = CacheConfig(page_size=16, num_pages=64, kv_dtype="int8" if layout == "int8" else "float16")
    ecfg = EngineConfig(max_model_len=256, cache=cache,
                        scheduler=SchedulerConfig(max_batch=4, chunk_size=64, prefill_buckets=(64,)))
    params = L.init_params(cfg, 0, "cpu")
    to = lambda tree, dev: {k: to(v, dev) if isinstance(v, dict) else
                            (v.to(dev) if torch.is_tensor(v) else v) for k, v in tree.items()}
    prompts = [np.random.default_rng(i).integers(2, 128, n).tolist() for i, n in enumerate((40, 7, 100))]
    llm = LLM(model_config=cfg, params=to(params, cuda), engine_config=ecfg, device=cuda)
    ex = llm.executor
    pool = ex.cache.latent[0] if layout == "latent" else ex.cache.k[0]
    assert pool.dtype == (torch.int8 if layout == "int8" else torch.float16)
    before = [fn.launches for fn in FP16_PATHS[layout]]
    with DynamicBatchGenerator(llm) as gen:
        res = gen.batch_generate(prompts, [GeneratorArg(max_length=12)] * 3, timeout=300)
    assert all(len(r.outputs[0].token_ids) == 12 for r in res)
    assert all(fn.launches > b for fn, b in zip(FP16_PATHS[layout], before))

    plain = LLM(model_config=cfg, params=params, engine_config=ecfg, device="cpu").executor
    card, fed = _forced_logits(ex, prompts, 12)
    want, _ = _forced_logits(plain, prompts, 12, feed=fed)
    diff = max((c - w).abs().max().item() for c, w in zip(card, want))
    worst_rel, worst_gap = 0.0, 0.0
    for c, w in zip(card, want):
        worst_rel = max([worst_rel] + ((c - w).abs().amax(-1) / c.abs().amax(-1)).tolist())
        top2 = c.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        parted = (c.argmax(-1) != w.argmax(-1)).tolist()
        worst_gap = max([worst_gap] + [g for g, p in zip(gap, parted) if p])
    print(f"fp16 {layout}: teacher-forced largest |diff| {diff:.4e}, rel {worst_rel:.4e}")
    assert worst_rel <= FP16_LOGIT_TOL, f"logits differ by {worst_rel} of the largest"
    assert worst_gap <= 2 * diff, f"an argmax parted at a top-2 gap of {worst_gap} > 2 x {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_window_kv_engine_on_gpu(cuda, kv_dtype, monkeypatch):
    """A small bf16 model served with ZT_WINDOW_KV=1: 8-step windows run the
    partial kernel and one flush a window for every layer (the layered flush;
    no per-layer one), and write no row per step; the tokens equal the
    per-step engine's on the same weights."""
    cfg = L.ModelConfig(model_type="llama", num_layers=2, dim_model=256, num_heads=4, dim_head=64,
                        num_kv_heads=2, dim_ff=512, vocab_size=128, dtype="bfloat16")
    ecfg = EngineConfig(max_model_len=256,
                        cache=CacheConfig(page_size=16, num_pages=64, kv_dtype=kv_dtype),
                        scheduler=SchedulerConfig(max_batch=4, chunk_size=64, prefill_buckets=(64,)))
    params = L.init_params(cfg, 0, cuda)
    prompts = [np.random.default_rng(i).integers(2, 128, n).tolist() for i, n in enumerate((40, 7, 100))]
    partial = A.paged_decode_attention_hm_q_partial if kv_dtype == "int8" else A.paged_decode_attention_hm_partial
    # every row write into the packed pool: the prologue (the model's) and the copy mode
    row_writes = lambda: W.rope_write_rows_hm.launches + W.write_rows_hm.launches
    runs, windows = {}, []
    flush_window_rows = L.flush_window_rows
    monkeypatch.setattr(L, "flush_window_rows",
                        lambda *a, **kw: windows.append(1) or flush_window_rows(*a, **kw))
    for window in (False, True):
        if window:
            monkeypatch.setenv("ZT_WINDOW_KV", "1")
        llm = LLM(model_config=cfg, params=params, engine_config=ecfg, device=cuda)
        assert llm.executor.window_kv == window and llm.executor.decode_window == 8
        with DynamicBatchGenerator(llm) as gen:
            # the same prompts' prefill alone, then prefill and decode
            w0 = row_writes()
            gen.batch_generate(prompts, [GeneratorArg(max_length=1)] * 3, timeout=300)
            before = (W.flush_side_layers_hm.launches, partial.launches, row_writes(),
                      W.flush_side_rows_hm.launches)
            windows.clear()
            res = gen.batch_generate(prompts, [GeneratorArg(max_length=16)] * 3, timeout=300)
        prefill_writes = before[2] - w0
        runs[window] = [r.outputs[0].token_ids for r in res]
        flushes, partials, writes, per_layer = (n - b for n, b in zip(
            (W.flush_side_layers_hm.launches, partial.launches, row_writes(),
             W.flush_side_rows_hm.launches), before))
        assert per_layer == 0
        if window:  # decode writes no row per step: one flush a window, every layer in it
            assert flushes == len(windows) > 0 and partials > 0 and writes == prefill_writes
        else:
            assert flushes == partials == 0 and writes > prefill_writes
    assert all(len(t) == 16 for t in runs[True])
    same = sum(a == b for x, y in zip(runs[True], runs[False]) for a, b in zip(x, y))
    assert same >= 0.9 * 48  # bf16: the merge rounds differently from the one-pass kernel


# ---------------------------------------------------------------------------
# fused write + attend (ZT_FUSED_KV=1)
# ---------------------------------------------------------------------------

# contexts counting the new token: 3712 (ranges merged), 1 (the new row
# alone), 0 (empty), the new row on a page's last row (16) and first row
# (17); slot 5 frozen, slots 6 and 7 share their first 4 pages (read only)
_FUSED_CTX = [3712, 1, 0, 16, 17, 300, 700, 129]


def _fused_inputs(rng, device, ctx):
    """Page tables (sequences 6 and 7 sharing a read-only prefix), and the
    new rows' slots: the row at position ctx - 1; -1 for the empty and the
    frozen sequence."""
    ctx = np.array(ctx, np.int32)
    tables, npages = _tables(rng, ctx, device)
    tables = tables.cpu().numpy()
    tables[7, :4] = tables[6, :4]
    slots = np.array([tables[b, (c - 1) // S] * S + (c - 1) % S if c > 0 else -1
                      for b, c in enumerate(ctx)], np.int32)
    slots[5] = -1
    i32 = lambda a: torch.from_numpy(a).to(device)
    return i32(tables), npages, i32(slots), i32(ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hkv,G,D", [(2, 1, 16), (2, 8, 16), (2, 4, 80), (2, 8, 128),
                                     (8, 1, 16), (8, 4, 80), (8, 5, 128), (8, 8, 128),
                                     (12, 2, 64)])
def test_fused_decode_attention_matches_plain(cuda, dtype, hkv, G, D, packed):
    """Danube's (8 KV heads, G 4, head_dim 80) and Qwen2.5-14B's (G 5 of 128)
    geometries among others, at batch 8 over _FUSED_CTX, windows 0 and 300."""
    rng = np.random.default_rng(hkv * G + D + packed)
    tables, npages, slots, ctx = _fused_inputs(rng, cuda, _FUSED_CTX)
    k, v = _rand(dtype, rng, cuda, npages * S, hkv, D), _rand(dtype, rng, cuda, npages * S, hkv, D)
    pools = (torch.cat((k, v), -1)[None],) if packed else (k[None], v[None])
    q = _rand(dtype, rng, cuda, 8, hkv * G, D)
    k_new, v_new = _rand(dtype, rng, cuda, 8, hkv, D), _rand(dtype, rng, cuda, 8, hkv, D)
    for window in (0, 300):
        got_pools = [p.clone() for p in pools]
        want_pools = [p.clone() for p in pools]
        tail = (k_new, v_new, slots, tables, ctx, S, 1.0 / np.sqrt(D), window)
        before = PA.paged_decode_attention_fused.launches
        got = PA.paged_decode_attention_fused(q, got_pools[0], None if packed else got_pools[1],
                                              *tail)
        want = PA.paged_decode_attention_fused_plain(
            q, want_pools[0], None if packed else want_pools[1], *tail)
        torch.cuda.synchronize()
        assert PA.paged_decode_attention_fused.launches == before + 1
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max().item() <= TOL
        assert all(torch.equal(g, w) for g, w in zip(got_pools, want_pools))
        # the empty slot gives its new V row, the written rows are the new ones
        assert (got[2].float() - v_new[2].repeat_interleave(G, 0).float()).abs().max() <= TOL
        assert not all(torch.equal(g, p) for g, p in zip(got_pools, pools))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("B,H,ctx", [(8, 16, [2816, 1, 0, 16, 17, 1500, 100, 2305]),
                                     (3, 16, [300, 1, 65]), (2, 40, [3000, 64])])
def test_mla_decode_fused_matches_plain(cuda, dtype, B, H, ctx):
    """DeepSeek-V2-Lite's latent rows (576, V the first 512) and 16 heads at
    its serving batch, and smaller batches; pools [1, N, 576]."""
    rng = np.random.default_rng(B + H)
    tables, npages, slots, ctx_t = _fused_inputs(rng, cuda, ctx + [0] * (8 - B))
    tables, slots, ctx_t = tables[:B], slots[:B].clone(), ctx_t[:B]
    if B == 8:
        slots[5] = -1  # frozen
    pool = _rand(dtype, rng, cuda, 1, npages * S, 576)
    q, new = _rand(dtype, rng, cuda, B, H, 576), _rand(dtype, rng, cuda, B, 576)
    got_pool, want_pool = pool.clone(), pool.clone()
    tail = (new, slots, tables, ctx_t, S, 1.0 / np.sqrt(192), 512)
    got = PA.paged_mla_decode_fused(q, got_pool, *tail)
    want = PA.paged_mla_decode_fused_plain(q, want_pool, *tail)
    torch.cuda.synchronize()
    assert got.shape == (B, H, 512) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert torch.equal(got_pool, want_pool) and not torch.equal(got_pool, pool)


@pytest.mark.cuda
def test_fused_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    q = torch.zeros(2, 4, 80, dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros(1, 64, 2, 80, dtype=torch.bfloat16, device=cuda)
    rows = torch.zeros(2, 2, 80, dtype=torch.bfloat16, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    slots, tables, ctx = torch.zeros(2, **i32), torch.zeros(2, 4, **i32), torch.ones(2, **i32)
    fused = PA.paged_decode_attention_fused
    with pytest.raises(NotImplementedError):
        fused(q.float(), pool, pool, rows, rows, slots, tables, ctx, S, 0.1)        # fp32 q
    with pytest.raises(NotImplementedError):
        fused(q, pool.float(), pool.float(), rows, rows, slots, tables, ctx, S, 0.1)  # fp32 pools
    with pytest.raises(ValueError):
        fused(q, pool, pool, rows, rows, slots, tables.long(), ctx, S, 0.1)        # int64 tables
    with pytest.raises(ValueError):
        fused(q, pool, None, rows, rows, slots, tables, ctx, S, 0.1)               # not [.., 2D]
    with pytest.raises(ValueError):
        fused(q, pool, pool, rows[:1], rows, slots, tables, ctx, S, 0.1)           # rows [B, Hkv, D]
    with pytest.raises(ValueError):
        fused(q.transpose(0, 1).contiguous().transpose(0, 1), pool, pool, rows, rows, slots,
              tables, ctx, S, 0.1)                                                # not contiguous
    wide = torch.zeros(2, 4, 272, dtype=torch.bfloat16, device=cuda)
    wpool = torch.zeros(1, 64, 2, 272, dtype=torch.bfloat16, device=cuda)
    wrows = torch.zeros(2, 2, 272, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        fused(wide, wpool, wpool, wrows, wrows, slots, tables, ctx, S, 0.1)        # D > 256
    lq = torch.zeros(2, 16, 576, dtype=torch.bfloat16, device=cuda)
    lpool = torch.zeros(1, 64, 576, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        PA.paged_mla_decode_fused(lq, lpool, lpool[0, :2], slots, tables, ctx, S, 0.1, 256)
    with pytest.raises(ValueError):
        PA.paged_mla_decode_fused(lq, lpool, lpool[0, :2, :512], slots, tables, ctx, S, 0.1, 512)
    with pytest.raises(ValueError):
        PA.paged_mla_decode_fused(lq, lpool, lpool[0, :2], slots.long(), tables, ctx, S, 0.1, 512)


# largest |fused - unfused| decode logit over the row's largest |logit|: the
# fused kernel folds the new token's column in fp32 (its score by a warp sum,
# its V row weighted unrounded), where the unfused kernel reads the same bf16
# row back from the pool as one more tile column (score from the tensor-core
# sum, p split into two bf16 halves). The fp32 results differ by ulps; where
# one crosses a bf16 rounding boundary of the attention output, that element
# moves by 2^-8 of itself. Measured on an H100 (2 layers, head_dim 80): up to
# 8.97e-3, in the short context only, where the new token weighs most; rows
# of contexts over 40 agree to the bit.
FUSED_LOGIT_TOL = 2e-2
# largest |card - plain| fp16 logit over the row's largest: the kernels' fp32
# sums in another order and their own rounding points (p rounded unnormalized)
# against the plain path's on the CPU, through two fp16 layers
FP16_LOGIT_TOL = 2e-2


def _teacher_forced(ex_u, ex_f, prompts, steps):
    """Each prompt prefilled once (unfused executor, one chunk) into a scratch
    cache, which is then copied; then ``steps`` decode steps of the batch on
    both copies, the fused executor's and the unfused one's, both fed the
    unfused argmax. Returns per step the logits [B, V] of both."""
    cfg, B = ex_u.cfg, len(prompts)
    i32 = dict(dtype=torch.int32, device=ex_u.device)
    maxp = max(len(p) + steps for p in prompts) // S + 1
    cache = ex_u.new_cache(B * maxp)
    tables = torch.arange(B * maxp, **i32).reshape(B, maxp)
    rows = torch.arange(B, device=ex_u.device)
    slots = lambda b, pos: (tables[b, (pos // S).long()] * S + pos % S).to(torch.int32)
    out = []
    with torch.no_grad():
        first = []
        for b, p in enumerate(prompts):
            pos = torch.arange(len(p), **i32)
            meta = PrefillMeta(positions=pos, slot_mapping=slots(b, pos), page_table=tables[b],
                               cache_len=torch.tensor(0, **i32), q_len=torch.tensor(len(p), **i32))
            logits, cache = L.forward_prefill(ex_u.params, cfg, ex_u.rope,
                                              torch.tensor(p, **i32), meta, cache)
            first.append(int(logits.argmax()))
        caches = {False: cache, True: dataclasses.replace(cache, **{
            f: [a.clone() for a in getattr(cache, f)] for f in ("k", "v") if getattr(cache, f)})}
        tokens = torch.tensor(first, **i32)
        n = torch.tensor([len(p) for p in prompts], **i32)
        for k in range(steps):
            pos = n + k
            step = {}
            for fused, ex in ((False, ex_u), (True, ex_f)):
                meta = DecodeMeta(positions=pos, slot_mapping=slots(rows, pos),
                                    page_tables=tables, context_lens=pos + 1, fused=fused)
                step[fused], caches[fused] = L.forward_decode(ex.params, cfg, ex.rope, tokens,
                                                              meta, caches[fused])
            out.append((step[False], step[True]))
            tokens = step[False].argmax(-1).to(torch.int32)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dim_head", [80, 64])
def test_fused_kv_engine_on_gpu(cuda, dim_head, monkeypatch):
    """A small bf16 model served with ZT_FUSED_KV=1: over a slot-major pool
    (head_dim 80) the decode steps launch the fused kernel and no unfused
    decode or row write; over the packed pool (head_dim 64) the mode stays
    off, and its decode rows go through the packed pool's prologue. Each
    request gets its 16 tokens. Then the same prompts teacher-forced (both
    executors fed the unfused argmax, 15 decode steps): every step's logits
    within FUSED_LOGIT_TOL of the row's largest, and the same argmax wherever
    the unfused top-2 gap exceeds twice the largest measured difference (a
    near-tie on a random model may part the greedy tokens; counting tokens
    positionally would charge one such tie to every later token)."""
    cfg = L.ModelConfig(model_type="llama", num_layers=2, dim_model=256, num_heads=4,
                        dim_head=dim_head, num_kv_heads=2, dim_ff=512, vocab_size=128,
                        dtype="bfloat16")
    ecfg = EngineConfig(max_model_len=256, cache=CacheConfig(page_size=16, num_pages=64),
                        scheduler=SchedulerConfig(max_batch=4, chunk_size=64, prefill_buckets=(64,)))
    params = L.init_params(cfg, 0, cuda)
    prompts = [np.random.default_rng(i).integers(2, 128, n).tolist() for i, n in enumerate((40, 7, 100))]
    write = W.rope_write_rows_pair if dim_head == 80 else W.rope_write_rows_hm
    counted = (PA.paged_decode_attention_fused, PA.paged_decode_attention,
               A.paged_decode_attention_hm, write)
    runs, execs = {}, {}
    for fused in (False, True):
        if fused:
            monkeypatch.setenv("ZT_FUSED_KV", "1")
        llm = LLM(model_config=cfg, params=params, engine_config=ecfg, device=cuda)
        assert llm.executor.fused_kv == fused
        execs[fused] = llm.executor
        with DynamicBatchGenerator(llm) as gen:
            # the same prompts' prefill alone, then prefill and decode
            w0 = write.launches
            gen.batch_generate(prompts, [GeneratorArg(max_length=1)] * 3, timeout=300)
            before = [fn.launches for fn in counted]
            res = gen.batch_generate(prompts, [GeneratorArg(max_length=16)] * 3, timeout=300)
        runs[fused] = [r.outputs[0].token_ids for r in res]
        n_fused, n_slot, n_hm, writes = (fn.launches - b for fn, b in zip(counted, before))
        if fused and dim_head == 80:  # decode writes no row apart from the fused kernel's
            assert n_fused > 0 and n_slot == 0 and writes == before[3] - w0
        else:
            assert n_fused == 0 and n_slot + n_hm > 0 and writes > before[3] - w0
    assert all(len(t) == 16 for t in runs[True] + runs[False])

    steps = _teacher_forced(execs[False], execs[True], prompts, 15)
    diff = max((f - u).abs().max().item() for u, f in steps)
    print(f"fused vs unfused, head_dim {dim_head}, teacher-forced: largest |diff| {diff:.4e}; "
          f"greedy tokens equal {sum(a == b for x, y in zip(runs[True], runs[False]) for a, b in zip(x, y))}/48")
    worst_rel, worst_gap = 0.0, 0.0  # worst gap: the largest top-2 gap where the argmax parted
    for k, (u, f) in enumerate(steps):
        rel = ((f - u).abs().amax(-1) / u.abs().amax(-1)).tolist()
        top2 = u.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        parted = (u.argmax(-1) != f.argmax(-1)).tolist()
        print(f"  step {k:2d}: rel diff " + " ".join(f"{r:.3e}" for r in rel) + "; unfused top-2 gap "
              + " ".join(f"{g:.3e}{' (parted)' if p else ''}" for g, p in zip(gap, parted)))
        worst_rel = max([worst_rel] + rel)
        worst_gap = max([worst_gap] + [g for g, p in zip(gap, parted) if p])
    assert worst_rel <= FUSED_LOGIT_TOL, f"logits differ by {worst_rel} of the largest"
    assert worst_gap <= 2 * diff, f"an argmax parted at a top-2 gap of {worst_gap} > 2 x {diff}"


@pytest.mark.cuda
def test_multimodal_engine_on_gpu(cuda):
    """Input embeddings and position ids on the card: a bf16 MLA + MoE model
    (latent pool, bf16 expert stacks) served through LLM +
    DynamicBatchGenerator. A prompt given as its own table rows returns the
    tokens of the prompt as token ids; an image prompt (random rows at the
    table's scale) with position ids 0..n-1 returns its tokens without them;
    the latent row write (rope_write_rows_2d) and the latent decode
    (paged_mla_decode) launch. Then that image prompt's first-token logits
    through the executor's cast of the rows, the card (kernels) against the
    same weights on the CPU (plain versions): within FP16_LOGIT_TOL of the
    largest, the same argmax wherever the top-2 gap exceeds twice the largest
    difference."""
    from zhilight_tpu_torch.config import MLAConfig, MoEConfig

    cfg = L.ModelConfig(model_type="deepseek_v2", num_layers=2, dim_model=256, num_heads=4,
                        dim_head=96, num_kv_heads=4, dim_ff=512, vocab_size=128, dtype="bfloat16",
                        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=32, qk_rope_head_dim=64,
                                      v_head_dim=32),
                        moe=MoEConfig(num_experts=8, top_k=2, intermediate_size=128,
                                      shared_expert_intermediate_size=128, first_k_dense_replace=1))
    ecfg = EngineConfig(max_model_len=256, cache=CacheConfig(page_size=16, num_pages=64),
                        scheduler=SchedulerConfig(max_batch=4, chunk_size=64, prefill_buckets=(64,)))
    params = L.init_params(cfg, 0, "cpu")
    to = lambda tree, dev: {k: to(v, dev) if isinstance(v, dict) else
                            (v.to(dev) if torch.is_tensor(v) else v) for k, v in tree.items()}
    llm = LLM(model_config=cfg, params=to(params, cuda), engine_config=ecfg, device=cuda)
    ex = llm.executor
    assert ex.cache.is_latent
    table = ex.params["embedding"]["w"]
    rng = np.random.default_rng(5)
    text = rng.integers(2, 128, 90).tolist()
    image = rng.integers(2, 128, 100).tolist()
    rows = table[torch.tensor(image, device=cuda)].float()
    rows[20:84] = torch.randn(64, cfg.dim_model, device=cuda) * table.float().std()
    rows = rows.cpu().numpy()
    pos = np.arange(len(image), dtype=np.int32)
    before = (W.rope_write_rows_2d.launches, A.paged_mla_decode.launches)
    arg = GeneratorArg(max_length=12)
    with DynamicBatchGenerator(llm) as gen:
        as_ids = gen.generate(text, arg, timeout=300).outputs[0].token_ids
        as_rows = gen.generate(text, arg, timeout=300,
                               input_embeddings=table[text].float().cpu().numpy()).outputs[0].token_ids
        img = gen.generate(image, arg, timeout=300, input_embeddings=rows).outputs[0].token_ids
        img_pos = gen.generate(image, arg, timeout=300, input_embeddings=rows,
                               position_ids=pos).outputs[0].token_ids
    assert as_rows == as_ids and img_pos == img and len(img) == 12
    assert W.rope_write_rows_2d.launches > before[0] and A.paged_mla_decode.launches > before[1]

    plain = LLM(model_config=cfg, params=params, engine_config=ecfg, device="cpu").executor

    def first_logits(e):
        n = len(image)
        i32 = dict(dtype=torch.int32, device=e.device)
        pages = -(-n // S)
        meta = PrefillMeta(positions=torch.arange(n, **i32), slot_mapping=torch.arange(n, **i32),
                           page_table=torch.arange(pages, **i32),
                           cache_len=torch.tensor(0, **i32), q_len=torch.tensor(n, **i32))
        with torch.no_grad():
            logits, _ = L.forward_prefill(e.params, cfg, e.rope, torch.tensor(image, **i32), meta,
                                          e.new_cache(pages), e._emb_arg(rows, n))
        return logits.float().cpu()

    card, want = first_logits(ex), first_logits(plain)
    diff = (card - want).abs().max().item()
    top2 = card.topk(2).values
    print(f"multimodal: first-token logits card vs CPU plain: largest |diff| {diff:.4e}, "
          f"rel {diff / want.abs().max().item():.4e}")
    assert diff <= FP16_LOGIT_TOL * want.abs().max().item()
    assert int(card.argmax()) == int(want.argmax()) or (top2[0] - top2[1]).item() <= 2 * diff


# a bf16 tree's dense layer linears as symmetric int4 entries (groups of 128
# rows, round to nearest; planar where K allows): the card's GPTQ-like TP model
QUANTIZE_INT4 = r"""
def quantize_int4(params, gs=128):
    from zhilight_tpu_torch.ops.quant import pack_int4
    for layer in params["layers"].values():
        for group in (layer["attn"], layer["mlp"]):
            for name, p in list(group.items()):
                K, N = p["w"].shape
                g = p["w"].float().reshape(K // gs, gs, N)
                s = (g.abs().amax(1) / 7).clamp_min(1e-8)
                q = (torch.round(g / s[:, None]) + 8).clamp(0, 15).to(torch.int8).reshape(K, N)
                group[name] = dict({"w_p": pack_int4(q) if K % 256 == 0 else q, "scales": s,
                                    "zeros": torch.full_like(s, 8.0)},
                                   **({"b": p["b"]} if "b" in p else {}))
    return params
"""
exec(QUANTIZE_INT4)


TP_RANK = r"""
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
spec = json.load(open(os.path.join(tmp, "spec.json")))
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, MLAConfig, ModelConfig,
                                       MoEConfig, ParallelConfig, SchedulerConfig)
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg, SearchTask
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as L
from zhilight_tpu_torch.models import moe as M
from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.ops.cuda import prefill_attention as P
from zhilight_tpu_torch.ops.cuda import quant_matmul as Q
from zhilight_tpu_torch.parallel.sharding import shard_params
exec(spec["quantize"])

finished = {}
finish = SearchTask.finish
def recorded(self):
    finished[str(self.task_id)] = [int(t) for t in self.output_tokens]
    finish(self)
SearchTask.finish = recorded
model = dict(spec["model"])
for key, kind in (("mla", MLAConfig), ("moe", MoEConfig)):
    if key in model:
        model[key] = kind(**model[key])
cfg = ModelConfig(**model)
if spec["int4"]:  # the whole tree quantized, then the rank's shard of it
    params = shard_params(quantize_int4(L.init_params(cfg, 0, "cuda:0")), rank, 2, cfg=cfg)
else:
    params = L.init_params(cfg, 0, "cuda:0", shard=(rank, 2))
# "cuda" with no index: the rank's device is cuda:LOCAL_RANK, 0 for both ranks here
llm = LLM(model_config=cfg, params=params, device="cuda", engine_config=EngineConfig(
    max_model_len=512, cache=CacheConfig(page_size=16, num_pages=128),
    scheduler=SchedulerConfig(max_batch=4, chunk_size=128, prefill_buckets=(128,)),
    parallel=ParallelConfig(tp=2)))
assert llm.device == torch.device("cuda", 0), llm.device
modules = dict(A=A, W=W, P=P, Q=Q)
counted = [getattr(modules[m], name) for m, name in spec["kernels"]]
for fn in counted:
    fn.launches = 0
gen = DynamicBatchGenerator(llm).start()
out = {}
if rank == 0:
    out["greedy"] = [r.outputs[0].token_ids for r in gen.batch_generate(
        spec["prompts"], GeneratorArg(max_length=12, ignore_eos=True), timeout=120)]
    gen.stop()
else:
    gen.scheduler._thread.join(timeout=120)
    assert not gen.scheduler._thread.is_alive() and gen.scheduler.error is None
out["launches"] = [fn.launches for fn in counted]
out["finished"] = finished
out["experts"] = sorted({v.shape[0] for layer in llm.executor.params["layers"].values()
                         for proj in layer["mlp"].get("experts", {}).values()
                         for v in proj.values()})
# MoE routing shared with the TP=1 run's, in the same order: where a token's
# experts part, the parting must be a near tie (the TP=1 gap between its k-th
# expert and this rank's pick at most twice the row's largest router-logit
# difference), and the token takes TP=1's experts and weights
routes, parted = (torch.load(os.path.join(tmp, "routes.pt"))
                  if os.path.exists(os.path.join(tmp, "routes.pt")) else None), []
select = M.select_experts
def shared(logits, m, bias=None):
    weights, ids = select(logits, m, bias)
    o_logits, o_ids, o_weights = (t.to(logits.device) for t in routes.pop(0))
    part = (ids.sort(-1).values != o_ids.sort(-1).values).any(-1)
    for r in part.nonzero().flatten().tolist():
        own = sorted(set(ids[r].tolist()) - set(o_ids[r].tolist()))
        gap = o_logits[r, o_ids[r].long()].min() - o_logits[r, own].max()
        parted.append((gap / (o_logits[r] - logits[r].float()).abs().max()).item())
    return (torch.where(part[:, None], o_weights, weights),
            torch.where(part[:, None], o_ids, ids))
if routes is not None:
    M.select_experts = shared
# teacher-forced along the TP=1 tokens: every rank scores together
forced = [llm.executor.run_score(np.asarray(p + t, np.int32))[len(p) - 1 : -1]
          for p, t in zip(spec["prompts"], spec["tokens"])]
out["parted"] = parted
out["routes_left"] = None if routes is None else len(routes)
np.save(os.path.join(tmp, f"forced{rank}.npy"), np.stack(forced))
json.dump(out, open(os.path.join(tmp, f"rank{rank}.json"), "w"))
dist.barrier()
dist.destroy_process_group()
"""


# the card's TP engine cases: model fields (MLA and MoE nested), the kernels
# each rank must launch (module, name), the teacher-forced tolerance (the
# card's 5e-2 for MLA + MoE logits)
TP_MODELS = {
    # Qwen2.5-14B's TP=2 rank geometry: 20 query / 4 KV heads of 128
    "qwen2": (dict(model_type="qwen2", num_layers=2, dim_model=512, num_heads=40, dim_head=128,
                   num_kv_heads=8, dim_ff=1024, vocab_size=1024, attn_bias=True,
                   dtype="bfloat16"),
              [("W", "rope_write_rows_hm"), ("A", "paged_decode_attention_hm"),
               ("P", "paged_prefill_attention_hm_packed")], 2e-2),
    # the same geometry with int4 linears (QUANTIZE_INT4): each rank's q/k/v and
    # gate/up columns, o (2560 of 5120 rows) and down rows with their groups,
    # row 4 in its fp32-output mode for o and down
    "qwen2_gptq": (dict(model_type="qwen2", num_layers=2, dim_model=512, num_heads=40,
                        dim_head=128, num_kv_heads=8, dim_ff=1024, vocab_size=1024,
                        attn_bias=True, dtype="bfloat16"),
                   [("W", "rope_write_rows_hm"), ("A", "paged_decode_attention_hm"),
                    ("P", "paged_prefill_attention_hm_packed"), ("Q", "w4a16_matmul")], 2e-2),
    # DeepSeek-V2-Lite's: 8 of 16 heads over the whole 512 + 64 latent, 32
    # of 64 bf16 experts (top 6), a shared expert, a dense first layer
    "deepseek_v2": (dict(model_type="deepseek_v2", num_layers=3, dim_model=512, num_heads=16,
                         dim_head=192, num_kv_heads=16, dim_ff=1024, vocab_size=1024,
                         dtype="bfloat16",
                         mla=dict(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                                  v_head_dim=128),
                         moe=dict(num_experts=64, top_k=6, intermediate_size=128,
                                  shared_expert_intermediate_size=256, first_k_dense_replace=1)),
                    [("W", "rope_write_rows_2d"), ("A", "paged_mla_decode")], 5e-2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", list(TP_MODELS))
def test_tensor_parallel_engine_on_gpu(cuda, tmp_path, model_type):
    """Tensor parallelism on the card: a bf16 model at Qwen2.5-14B's TP=2
    rank geometry (a rank holds 20 query / 4 KV heads of 128), and one at
    DeepSeek-V2-Lite's (8 of 16 MLA heads over a whole latent pool, 32 of
    64 experts), served by two rank processes on the one GPU over a gloo
    group, each drawing the full weights from the seed and keeping its
    shard. Both ranks finish every request with the same tokens and score
    the same logits bit for bit (each given the device "cuda", which
    resolves to ``cuda:LOCAL_RANK``); the path's kernels launch on both; the
    TP=2 logits, teacher-forced along the TP=1 run's greedy tokens, lie
    within 2e-2 of the largest TP=1 logit, with the TP=1 argmax wherever its
    top-2 gap exceeds twice the largest difference, and the greedy tokens
    part, if at all, at such a near tie (5e-2 for the MLA + MoE model, as
    the card holds MLA + MoE logits). The MoE model's teacher-forced ranks
    share the TP=1 run's routing: where a token's experts part from TP=1's,
    the parting is a near tie, and the token takes TP=1's experts."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from unittest import mock

    from zhilight_tpu_torch.config import MLAConfig, MoEConfig
    from zhilight_tpu_torch.models import moe as M

    model, kernels, tol = TP_MODELS[model_type]
    nested = dict(model)
    for key, kind in (("mla", MLAConfig), ("moe", MoEConfig)):
        if key in nested:
            nested[key] = kind(**nested[key])
    cfg = L.ModelConfig(**nested)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 1024, n).tolist() for n in (40, 300)]
    int4 = model_type.endswith("gptq")
    params = L.init_params(cfg, 0, "cuda")
    one = LLM(model_config=cfg, params=quantize_int4(params) if int4 else params, device=cuda,
              engine_config=EngineConfig(max_model_len=512, cache=CacheConfig(page_size=16,
                                                                              num_pages=128),
                                         scheduler=SchedulerConfig(max_batch=4, chunk_size=128,
                                                                   prefill_buckets=(128,))))
    with DynamicBatchGenerator(one) as gen:
        tokens = [r.outputs[0].token_ids for r in gen.batch_generate(
            prompts, GeneratorArg(max_length=12, ignore_eos=True), timeout=120)]
    # the TP=1 run's routing, shared with the ranks' teacher-forced runs
    routes, select = [], M.select_experts

    def recorded(logits, m, bias=None):
        weights, ids = select(logits, m, bias)
        routes.append((logits.float().cpu(), ids.cpu(), weights.cpu()))
        return weights, ids

    with mock.patch.object(M, "select_experts", recorded):
        want = np.stack([one.executor.run_score(np.asarray(p + t, np.int32))[len(p) - 1 : -1]
                         for p, t in zip(prompts, tokens)])
    if routes:
        torch.save(routes, tmp_path / "routes.pt")
    (tmp_path / "spec.json").write_text(json.dumps(dict(model=model, prompts=prompts,
                                                        tokens=tokens, kernels=kernels,
                                                        int4=int4, quantize=QUANTIZE_INT4)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), LOCAL_RANK="0")
    procs = [subprocess.Popen([sys.executable, "-c", TP_RANK, str(r), str(port), str(tmp_path)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2))
    assert r0["finished"] and r0["finished"] == r1["finished"]
    assert all(n > 0 for n in r0["launches"] + r1["launches"]), (r0["launches"], r1["launches"])
    if cfg.moe.enabled:
        assert r0["experts"] == r1["experts"] == [cfg.moe.num_experts // 2]
        # every routing shared, every parting a near tie
        assert r0["routes_left"] == r1["routes_left"] == 0 and r0["parted"] == r1["parted"]
        assert all(ratio <= 2 for ratio in r0["parted"]), r0["parted"]
    got, other = np.load(tmp_path / "forced0.npy"), np.load(tmp_path / "forced1.npy")
    assert np.array_equal(got, other)
    diff = np.abs(got - want).max()
    assert diff <= tol * np.abs(want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    parted = got.argmax(-1) != want.argmax(-1)
    assert not parted.any() or gap[parted].max() <= 2 * diff
    for b, (w, g) in enumerate(zip(tokens, r0["greedy"])):
        first = next((k for k, (x, y) in enumerate(zip(w, g)) if x != y), None)
        assert first is None or gap[b, first] <= 2 * diff, (b, first)
