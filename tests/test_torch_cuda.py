"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: each test skips on a machine without a CUDA GPU (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Inputs are unit-variance bf16 from a numpy seed. Tolerance: the KV write is
bit-exact; attention outputs agree within 2e-2 absolute (bf16 output
rounding plus the kernels' fp32 probabilities against the plain version's
bf16-rounded ones).
"""

import numpy as np
import pytest
import torch

from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.ops.cuda import prefill_attention as P

S = 16
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(rng, device, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, torch.bfloat16)


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
@pytest.mark.parametrize("start,n", [(0, 16), (21, 40), (3205, 512)])
def test_write_rows_hm_is_exact(cuda, start, n):
    rng = np.random.default_rng(start)
    H, D = 36, 64
    pages = (start + n) // S + 3
    table = rng.permutation(pages)
    pos = np.arange(start, start + n)
    slots = torch.from_numpy((table[pos // S] * S + pos % S).astype(np.int32)).to(cuda)
    slots[n // 3] = -1
    k, v = _bf16(rng, cuda, n, H, D), _bf16(rng, cuda, n, H, D)
    pool = _bf16(rng, cuda, H, pages * S, 2 * D)
    got = W.write_rows_hm(pool.clone(), k, v, slots)
    assert torch.equal(got, W.write_rows_hm_plain(pool.clone(), k, v, slots))


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,D,window", [(36, 36, 64, 0), (32, 8, 128, 0), (16, 1, 64, 50)])
def test_decode_attention_matches_plain(cuda, hq, hkv, D, window):
    rng = np.random.default_rng(hq + D)
    B = 8
    ctx = rng.integers(1, 700, B).astype(np.int32)
    ctx[2] = 0
    tables, npages = _tables(rng, ctx, cuda)
    pool = _bf16(rng, cuda, hkv, npages * S, 2 * D)
    args = (_bf16(rng, cuda, B, hq, D), pool, tables, torch.from_numpy(ctx).to(cuda), S,
            1.0 / np.sqrt(D), window)
    got = A.paged_decode_attention_hm(*args)
    want = A.paged_decode_attention_hm_plain(*args)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert (got.float() - want.float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,D", [(8, 2, 64), (36, 36, 64), (8, 8, 128)])
def test_prefill_attention_matches_plain(cuda, hq, hkv, D):
    rng = np.random.default_rng(hq + D)
    TC = 96
    cache_lens = np.array([0, 45, 7], np.int32)
    q_lens = np.array([96, 50, 0], np.int32)
    tables, npages = _tables(rng, cache_lens + q_lens, cuda)
    pool = _bf16(rng, cuda, hkv, npages * S, 2 * D)
    q = _bf16(rng, cuda, len(q_lens) * TC, hq, D)
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
