"""Paged decode attention over the head-major packed K|V pool.

Counterpart of ``zhilight_tpu/ops/pallas/attn_headmajor.py``
``paged_decode_attention_hm`` (:151) in its default mode, and of
``paged_decode_attention_hm_q`` (:341), the same attention over an int8 pool
with per-(token, KV head) fp32 scales. The CUDA kernels are
``csrc/attn_headmajor.cu`` and ``csrc/attn_headmajor_q.cu``; the plain PyTorch
versions are :func:`paged_decode_attention_hm_plain` (page gather +
``ops.attention``) and :func:`paged_decode_attention_hm_q_plain`. The wrappers
take the plain versions only for CPU tensors; for CUDA tensors they launch the
kernel or raise.

Both kernels take head_dim 64, 128, 192 and 256 with any number of query
heads per KV head. They split each context over several blocks when the
batch alone would not fill the card (:func:`decode_splits` picks the count
from the shapes and each kernel's occupancy) and merge their partials in the
same launch; the wrapper allocates the partials per call and keeps a zeroed
ticket buffer per device for the merge. The bf16 kernel rounds the
unnormalized probabilities to bf16 for the P.V product, as the TPU kernel
does.

The int8 functions never dequantize K or V elements: the K scale multiplies
the fp32 scores and the V scale the probabilities. The kernel rounds ``p *
v_scale`` of the unnormalized p to bf16 before the second product, as the
TPU kernel does. The scales are head-major ``[Hkv, >= N]``
(``kvcache/paged.py``), where the reference keeps them ``[N, Hkv]``.

The plain versions round where the XLA path rounds (the normalized
probabilities, or ``softmax * v_scale``), as the CPU model path needs; the
twins (:func:`paged_decode_attention_hm_twin`,
:func:`paged_decode_attention_hm_q_twin`) round where the kernels round and
divide by ``l`` last. Tests hold the twins to the Pallas kernels on bf16
inputs, and ``chip_smoke.py`` holds the CUDA kernels to both.

The MLA latent mode of ``paged_decode_attention_hm`` (``v_dim > 0``: one
shared latent row per token, scores over its first ``k_dim`` elements, values
its first ``v_dim``) is :func:`paged_mla_decode`, the counterpart of
``zhilight_tpu/ops/pallas/paged_attention.py`` ``paged_mla_decode`` (:791);
its CUDA kernel is ``csrc/mla_decode.cu`` (576 / 512 bf16 latents, any number
of heads, any page size) and its plain version :func:`paged_mla_decode_plain`.
``paged_decode_attention_hm(..., v_dim=...)`` goes there. The kernel is a
split-context flash decode on the tensor cores, one launch a layer: blocks of
16 heads, one wave of equal 16-token runs of the context (:func:`mla_splits`:
a power of two up to 16), each latent row copied once (one bulk copy a row)
for all 16 heads; the splits of a (sequence, head tile) are one thread block
cluster and merge on chip, through distributed shared memory. Bound on the
H100: bytes (each latent row read once a head tile). Its normal mode rounds
the unnormalized probabilities to bf16 before P.V and divides by ``l`` last,
as the TPU kernel (``_kernel_hm``) does: :func:`paged_mla_decode_twin`
rounds the same way, and :func:`paged_mla_decode_plain` where the XLA path
rounds (the normalized probabilities). Its partial mode, like the fused latent mode
(``ops/cuda/paged_attention.paged_mla_decode_fused``), keeps the
probabilities unrounded, as the reference's ``_kernel_bs`` does: the kernel
puts each through P.V as two bf16 halves. What holds it back is in the
kernel's header (a tile's trips through shared memory, above all).

Like the TPU kernels, an empty slot (``context_lens[b] == 0``) yields zeros.

``emit_partial=True`` (window side-KV: ``models/llama.py``
``_side_window_attention``) returns the flash partials over the pool instead
of the normalized output: fp32 ``(m, l, acc)``, the running max of the scaled
scores, the sum of ``exp(s - m)`` and the unnormalized ``sum exp(s - m) * V``.
The reference packs them into lanes (``[B, Hkv, G, 2D]``: lane 0 m, lane 1 l,
``[D:]`` acc; the MLA form ``[B, H, 128 + v_dim]``); the port returns them
apart, ``m``, ``l`` ``[B, Hkv, G]`` and ``acc`` ``[B, Hkv, G, D]`` (MLA:
``[B, H]``, ``[B, H, v_dim]``). An empty context gives m = -2e38, l = 0,
acc = 0. The partial modes are the same CUDA kernels with their last pass
writing the partials (``*_partial`` wrappers, each with its own launch
counter), and have plain versions beside them (``*_partial_plain``), whose
probabilities stay fp32 (the head-major kernels round them to bf16 for P.V,
inside the partials' tolerance; the latent kernel does not round them).

Every kernel here takes q, and a model-dtype pool, in bf16 or in fp16 (an
fp16 checkpoint's; never mixed): "bf16" above reads q's type, to which the
kernels round where the reference rounds to ``kv.dtype`` or ``q.dtype``
(``attn_headmajor.py:118``, ``:319``). The softmax's running max and sum stay
fp32 in both.
"""

from __future__ import annotations

import ctypes

import torch

from ...kvcache.paged import gather_hm, gather_scales, slot_indices
from ..attention import NEG_INF, decode_attention
from . import _build

__all__ = [
    "paged_decode_attention_hm",
    "paged_decode_attention_hm_plain",
    "paged_decode_attention_hm_twin",
    "paged_decode_attention_hm_partial",
    "paged_decode_attention_hm_partial_plain",
    "paged_decode_attention_hm_q",
    "paged_decode_attention_hm_q_plain",
    "paged_decode_attention_hm_q_twin",
    "paged_decode_attention_hm_q_partial",
    "paged_decode_attention_hm_q_partial_plain",
    "paged_mla_decode",
    "paged_mla_decode_plain",
    "paged_mla_decode_twin",
    "paged_mla_decode_partial",
    "paged_mla_decode_partial_plain",
    "check_scales",
]


def _partial_probs(scores: torch.Tensor, mask: torch.Tensor):
    """Flash partials of fp32 ``scores`` [..., T] under ``mask``: the max m
    (-2e38 where nothing is valid), ``l = sum exp(s - m)`` and the
    probabilities ``exp(s - m)``, zero where masked."""
    s = torch.where(mask, scores, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), p


def _hm_mask(context_lens: torch.Tensor, kv_len: int, sliding_window: int) -> torch.Tensor:
    """[B, 1, 1, KV] validity of each gathered token of a decode step."""
    k_pos = torch.arange(kv_len, device=context_lens.device)[None, :]
    ctx = context_lens[:, None]
    mask = k_pos < ctx
    if sliding_window > 0:
        mask &= k_pos > ctx - 1 - sliding_window
    return mask[:, None, None]


def paged_decode_attention_hm_plain(
    q: torch.Tensor,             # [B, Hq, D]
    kv_pool: torch.Tensor,       # [Hkv, N, 2D]
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    k, v = gather_hm(kv_pool, page_tables, page_size)  # [B, KV, Hkv, D]
    out = decode_attention(q, k, v, context_lens, scale, sliding_window)
    return out.masked_fill((context_lens <= 0)[:, None, None], 0)


def paged_decode_attention_hm_partial_plain(
    q: torch.Tensor,             # [B, Hq, D]
    kv_pool: torch.Tensor,       # [Hkv, N, 2D]
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int: pool tokens to attend over
    page_size: int,
    scale: float,
    sliding_window: int = 0,
):
    B, Hq, D = q.shape
    Hkv = kv_pool.shape[0]
    k, v = gather_hm(kv_pool, page_tables, page_size)  # [B, KV, Hkv, D]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    m, l, p = _partial_probs(scores, _hm_mask(context_lens, k.shape[1], sliding_window))
    return m, l, torch.einsum("bkgs,bskd->bkgd", p, v.float())


def _twin_out(p_round, l, v, out_shape, dtype):
    """``sum p_round . V / max(l, 1e-20)`` in fp32, as dtype: the end of a
    twin (``p_round`` [B, Hkv, G, KV] already rounded, V [B, KV, Hkv, D])."""
    acc = torch.einsum("bkgs,bskd->bkgd", p_round.float(), v.float())
    return (acc / l.clamp_min(1e-20)[..., None]).reshape(out_shape).to(dtype)


def paged_decode_attention_hm_twin(
    q: torch.Tensor,             # [B, Hq, D]
    kv_pool: torch.Tensor,       # [Hkv, N, 2D]
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """The plain version in the kernels' rounding order (the TPU kernel's and
    the CUDA kernel's): the unnormalized ``p = exp(s - m)`` is rounded to the
    pool's dtype before P.V, ``l`` sums it unrounded, and the division by
    ``max(l, 1e-20)`` comes last; :func:`paged_decode_attention_hm_plain`
    rounds the normalized probabilities, as the XLA path does. One max over
    the whole context where the kernels keep a running one."""
    B, Hq, D = q.shape
    Hkv = kv_pool.shape[0]
    k, v = gather_hm(kv_pool, page_tables, page_size)  # [B, KV, Hkv, D]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    _, l, p = _partial_probs(scores, _hm_mask(context_lens, k.shape[1], sliding_window))
    return _twin_out(p.to(kv_pool.dtype), l, v, (B, Hq, D), q.dtype)


def _entry():
    fn = _build.library("attn_headmajor").zt_decode_attention_hm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, ctypes.c_longlong, i, i,
                       ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


# the split-context plan of the decode kernels (csrc/decode_split.cuh:
# attn_headmajor.cu, attn_headmajor_q.cu and the slot-major paged_decode.cuh):
# 64-token tiles, blocks of 16 query rows, at most 64 splits
_TILE, _ROWS, _MAX_SPLITS = 64, 16, 64
BF16_HEAD_DIMS = (64, 128, 192, 256)


def decode_splits(B: int, Hkv: int, G: int, max_ctx: int, capacity: int) -> int:
    """How many blocks share the context of one (sequence, group of 16 query
    rows) in a split-context decode kernel: as many as let every block fit on
    the card at once (``capacity`` blocks: one wave, since a block that waits
    for a second wave doubles the time), no more than the 64-token tiles of the
    longest context the page tables can address (``max_ctx``, from their
    shape: no device read), at least 1 and at most 64. The kernel cuts each
    sequence's own tiles into that many whole-tile runs and skips the empty
    ones."""
    blocks = B * Hkv * -(-G // _ROWS)
    tiles = -(-max_ctx // _TILE)
    return max(1, min(capacity // max(blocks, 1), tiles, _MAX_SPLITS))


_CAPACITY: dict = {}
# the occupancy entry of each split-context decode kernel, by library: the
# head-major decodes (bf16, int8) and the slot-major ones
# (ops/cuda/paged_attention.py: bf16, int8, fused)
_OCCUPANCY = {"attn_headmajor": "zt_decode_attention_hm_blocks_per_sm",
              "attn_headmajor_q": "zt_decode_attention_hm_q_blocks_per_sm",
              "paged_attention": "zt_paged_decode_attention_blocks_per_sm",
              "paged_attention_q": "zt_paged_decode_attention_q_blocks_per_sm",
              "paged_attention_fused": "zt_paged_decode_attention_fused_blocks_per_sm",
              "mla_decode": "zt_mla_decode_blocks_per_sm"}


def _capacity(device, D: int, lib: str) -> int:
    """Blocks of library ``lib``'s head-dim-D decode kernel the card holds at
    once (occupancy times SMs), asked once per device."""
    cap = _CAPACITY.get((device, D, lib))
    if cap is None:
        fn = getattr(_build.library(lib), _OCCUPANCY[lib])
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
        n = ctypes.c_int(0)
        _build.check(fn(D, ctypes.byref(n)), f"{lib} occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cap = _CAPACITY[(device, D, lib)] = max(n.value, 1) * sms
    return cap


# per device: the kernels' int32 tickets, zero between launches (the kernel's
# last block of each (sequence, head group) resets its own); grown, never
# shrunk. One stream at a time uses them, as the engine runs decode; every
# split-context decode kernel shares them: the head-major bf16 and int8
# kernels and the slot-major ones (ops/cuda/paged_attention.py), since each
# launch leaves them at zero before the next on the same stream starts (the
# latent kernel merges on chip and takes none).
_TICKETS: dict = {}


def _tickets(device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def _outputs(q: torch.Tensor, Hkv: int, D: int, partial: bool):
    """The kernel's outputs and their three pointers (acc or out, m, l): a
    tensor like q, or fp32 (m, l, acc) shaped [B, Hkv, G] and [B, Hkv, G, D]."""
    B, Hq = q.shape[:2]
    if not partial:
        out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
        return out, (out.data_ptr(), None, None)
    f32 = dict(dtype=torch.float32, device=q.device)
    m, l = torch.empty((B, Hkv, Hq // Hkv), **f32), torch.empty((B, Hkv, Hq // Hkv), **f32)
    acc = torch.empty((B, Hkv, Hq // Hkv, D), **f32)
    return (m, l, acc), (acc.data_ptr(), m.data_ptr(), l.data_ptr())


def _check_hm(what: str, q, kv_pool, page_tables, context_lens, quant: bool):
    """The head-major kernels' shape, type and layout rules, shared by the
    model-dtype and int8 forms; returns (B, Hkv, G, D, N, maxp, fp16). Both
    take D in ``BF16_HEAD_DIMS`` with any G, q bf16 or fp16 (fp16: the flag of
    ``_build.elem_flag``), and a pool of q's type or int8 (``quant``)."""
    if not q.is_cuda:
        raise NotImplementedError(f"{what}: no kernel for device {q.device}")
    B, Hq, D = q.shape
    Hkv, N, D2 = kv_pool.shape
    if D2 != 2 * D or Hq % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)}, pool {tuple(kv_pool.shape)}")
    G = Hq // Hkv
    if quant and kv_pool.dtype != torch.int8:
        raise NotImplementedError(f"{what} kernel takes an int8 pool, got {kv_pool.dtype}")
    fp16 = _build.elem_flag(f"{what} (q{'' if quant else ' and pool'})",
                            q, *(() if quant else (kv_pool,)))
    if D not in BF16_HEAD_DIMS:
        raise NotImplementedError(f"{what} kernel: head_dim {D}")
    if page_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError(f"{what}: page_tables and context_lens must be int32")
    if page_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError(f"{what}: page_tables [B, maxp], context_lens [B]")
    for t in (q, kv_pool, page_tables, context_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and on one device")
    return B, Hkv, G, D, N, page_tables.shape[1], fp16


def split_shapes(B: int, Hkv: int, G: int, D: int, splits: int):
    """The split scratch of a decode launch with ``splits`` context splits:
    the shapes of the fp32 partials ``[B, heads, splits, 16, D]`` and their
    (m, l) ``[B, heads, splits, 2, 16]``, and the tickets it needs (one per
    (sequence, group of 16 query rows): ``heads = Hkv * ceil(G / 16)``)."""
    heads = Hkv * -(-G // _ROWS)
    return (B, heads, splits, _ROWS, D), (B, heads, splits, 2, _ROWS), B * heads


def _split_scratch(q, B: int, Hkv: int, G: int, D: int, maxp: int, page_size: int, lib: str):
    """The split count of a decode call of library ``lib``'s kernel and its
    split scratch: partials, their (m, l) and the tickets, or three None for
    one split."""
    splits = decode_splits(B, Hkv, G, maxp * page_size, _capacity(q.device, D, lib))
    if splits == 1:
        return splits, (None, None, None)
    acc, ml, n = split_shapes(B, Hkv, G, D, splits)
    f32 = dict(dtype=torch.float32, device=q.device)
    return splits, (torch.empty(acc, **f32), torch.empty(ml, **f32), _tickets(q.device, n))


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _launch_hm(what, q, kv_pool, page_tables, context_lens, page_size, scale, sliding_window,
               partial: bool):
    B, Hkv, G, D, N, maxp, fp16 = _check_hm(what, q, kv_pool, page_tables, context_lens,
                                            quant=False)
    result, ptrs = _outputs(q, Hkv, D, partial)
    splits, scratch = _split_scratch(q, B, Hkv, G, D, maxp, page_size, "attn_headmajor")
    err = _entry()(
        *ptrs, *_ptrs(scratch), q.data_ptr(), kv_pool.data_ptr(), page_tables.data_ptr(),
        context_lens.data_ptr(), B, Hkv, G, D, N, maxp, page_size, float(scale),
        int(sliding_window), splits, fp16, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, what)
    return result


def paged_decode_attention_hm(
    q: torch.Tensor,
    kv_pool: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
    emit_partial: bool = False,
    v_dim: int = 0,
):
    """Attention output [B, Hq, D] of each slot's query over its first
    ``context_lens[b]`` pool tokens, or with ``emit_partial`` its flash
    partials (m, l, acc). ``v_dim > 0`` is the MLA latent mode (pool
    ``[1, N, stored]``, output [B, Hq, v_dim]; no sliding window)."""
    if v_dim:
        if sliding_window or kv_pool.dim() != 3 or kv_pool.shape[0] != 1:
            raise ValueError("decode attention: the latent mode takes a [1, N, stored] pool "
                             "and no sliding window")
        return paged_mla_decode(q, kv_pool[0], page_tables, context_lens, page_size, scale, v_dim,
                                emit_partial=emit_partial)
    if emit_partial:
        return paged_decode_attention_hm_partial(q, kv_pool, page_tables, context_lens,
                                                 page_size, scale, sliding_window)
    if q.device.type == "cpu":
        return paged_decode_attention_hm_plain(
            q, kv_pool, page_tables, context_lens, page_size, scale, sliding_window
        )
    out = _launch_hm("paged_decode_attention_hm", q, kv_pool, page_tables, context_lens,
                     page_size, scale, sliding_window, partial=False)
    paged_decode_attention_hm.launches += 1
    return out


paged_decode_attention_hm.launches = 0


def paged_decode_attention_hm_partial(
    q: torch.Tensor,
    kv_pool: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
):
    """Flash partials (m, l, acc) of each slot's query over its first
    ``context_lens[b]`` pool tokens: the kernel of
    :func:`paged_decode_attention_hm` in its partial mode."""
    if q.device.type == "cpu":
        return paged_decode_attention_hm_partial_plain(
            q, kv_pool, page_tables, context_lens, page_size, scale, sliding_window
        )
    out = _launch_hm("paged_decode_attention_hm_partial", q, kv_pool, page_tables,
                     context_lens, page_size, scale, sliding_window, partial=True)
    paged_decode_attention_hm_partial.launches += 1
    return out


paged_decode_attention_hm_partial.launches = 0


# ---------------------------------------------------------------------------
# int8 pool
# ---------------------------------------------------------------------------

def paged_decode_attention_hm_q_plain(
    q: torch.Tensor,             # [B, Hq, D]
    kv_pool: torch.Tensor,       # [Hkv, N, 2D] int8
    k_scales: torch.Tensor,      # [Hkv, >= N] f32
    v_scales: torch.Tensor,      # [Hkv, >= N] f32
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    B, Hq, D = q.shape
    Hkv = kv_pool.shape[0]
    k, v = gather_hm(kv_pool, page_tables, page_size)         # [B, KV, Hkv, D] int8
    ks = gather_scales(k_scales, page_tables, page_size)      # [B, KV, Hkv]
    vs = gather_scales(v_scales, page_tables, page_size)
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    scores = scores * ks.transpose(1, 2)[:, :, None]
    scores = torch.where(_hm_mask(context_lens, k.shape[1], sliding_window), scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1) * vs.transpose(1, 2)[:, :, None]
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(q.dtype).float(), v.float())
    out = out.reshape(B, Hq, D).to(q.dtype)
    return out.masked_fill((context_lens <= 0)[:, None, None], 0)


def paged_decode_attention_hm_q_partial_plain(
    q: torch.Tensor,             # [B, Hq, D]
    kv_pool: torch.Tensor,       # [Hkv, N, 2D] int8
    k_scales: torch.Tensor,      # [Hkv, >= N] f32
    v_scales: torch.Tensor,      # [Hkv, >= N] f32
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int: pool tokens to attend over
    page_size: int,
    scale: float,
    sliding_window: int = 0,
):
    B, Hq, D = q.shape
    Hkv = kv_pool.shape[0]
    k, v = gather_hm(kv_pool, page_tables, page_size)         # [B, KV, Hkv, D] int8
    ks = gather_scales(k_scales, page_tables, page_size)      # [B, KV, Hkv]
    vs = gather_scales(v_scales, page_tables, page_size)
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    scores = scores * ks.transpose(1, 2)[:, :, None]
    m, l, p = _partial_probs(scores, _hm_mask(context_lens, k.shape[1], sliding_window))
    acc = torch.einsum("bkgs,bskd->bkgd", p * vs.transpose(1, 2)[:, :, None], v.float())
    return m, l, acc


def paged_decode_attention_hm_q_twin(
    q: torch.Tensor,             # [B, Hq, D]
    kv_pool: torch.Tensor,       # [Hkv, N, 2D] int8
    k_scales: torch.Tensor,      # [Hkv, >= N] f32
    v_scales: torch.Tensor,      # [Hkv, >= N] f32
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """The plain version in the kernels' rounding order: ``p * v_scale`` of
    the unnormalized ``p = exp(s - m)`` is rounded to q's dtype before P.V,
    ``l`` sums the unscaled p, and the division by ``max(l, 1e-20)`` comes
    last (:func:`paged_decode_attention_hm_q_plain` rounds ``softmax *
    v_scale``)."""
    B, Hq, D = q.shape
    Hkv = kv_pool.shape[0]
    k, v = gather_hm(kv_pool, page_tables, page_size)         # [B, KV, Hkv, D] int8
    ks = gather_scales(k_scales, page_tables, page_size)      # [B, KV, Hkv]
    vs = gather_scales(v_scales, page_tables, page_size)
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    scores = scores * ks.transpose(1, 2)[:, :, None]
    _, l, p = _partial_probs(scores, _hm_mask(context_lens, k.shape[1], sliding_window))
    return _twin_out((p * vs.transpose(1, 2)[:, :, None]).to(q.dtype), l, v, (B, Hq, D), q.dtype)


def check_scales(what: str, kv_pool, k_scales, v_scales) -> None:
    """The scale arrays an int8 kernel takes: fp32 ``[Hkv, >= N]`` on the
    pool's device, unit stride along the slots, one row stride for both."""
    Hkv, N, _ = kv_pool.shape
    for s in (k_scales, v_scales):
        if (s.dtype != torch.float32 or s.dim() != 2 or s.shape[0] != Hkv or s.shape[1] < N
                or s.stride(1) != 1 or s.device != kv_pool.device):
            raise ValueError(f"{what}: scales must be fp32 [Hkv, >= N] beside the pool, "
                             f"got {s.dtype} {tuple(s.shape)}")
    if k_scales.stride(0) != v_scales.stride(0):
        raise ValueError(f"{what}: k_scales and v_scales must share one row stride")


def _entry_q():
    fn = _build.library("attn_headmajor_q").zt_decode_attention_hm_q
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, i, i,
                       ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch_hm_q(what, q, kv_pool, k_scales, v_scales, page_tables, context_lens, page_size,
                 scale, sliding_window, partial: bool):
    B, Hkv, G, D, N, maxp, fp16 = _check_hm(what, q, kv_pool, page_tables, context_lens,
                                            quant=True)
    check_scales(what, kv_pool, k_scales, v_scales)
    result, ptrs = _outputs(q, Hkv, D, partial)
    splits, scratch = _split_scratch(q, B, Hkv, G, D, maxp, page_size, "attn_headmajor_q")
    err = _entry_q()(
        *ptrs, *_ptrs(scratch), q.data_ptr(), kv_pool.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), page_tables.data_ptr(), context_lens.data_ptr(), B, Hkv, G, D, N,
        k_scales.stride(0), maxp, page_size, float(scale), int(sliding_window), splits, fp16,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, what)
    return result


def paged_decode_attention_hm_q(
    q: torch.Tensor,
    kv_pool: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
    emit_partial: bool = False,
):
    """Attention output [B, Hq, D] of each slot's query over its first
    ``context_lens[b]`` tokens of the int8 pool, or with ``emit_partial`` its
    flash partials (m, l, acc)."""
    args = (q, kv_pool, k_scales, v_scales, page_tables, context_lens, page_size, scale,
            sliding_window)
    if emit_partial:
        return paged_decode_attention_hm_q_partial(*args)
    if q.device.type == "cpu":
        return paged_decode_attention_hm_q_plain(*args)
    out = _launch_hm_q("paged_decode_attention_hm_q", *args, partial=False)
    paged_decode_attention_hm_q.launches += 1
    return out


paged_decode_attention_hm_q.launches = 0


def paged_decode_attention_hm_q_partial(
    q: torch.Tensor,
    kv_pool: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
):
    """Flash partials (m, l, acc) over the int8 pool: the kernel of
    :func:`paged_decode_attention_hm_q` in its partial mode."""
    args = (q, kv_pool, k_scales, v_scales, page_tables, context_lens, page_size, scale,
            sliding_window)
    if q.device.type == "cpu":
        return paged_decode_attention_hm_q_partial_plain(*args)
    out = _launch_hm_q("paged_decode_attention_hm_q_partial", *args, partial=True)
    paged_decode_attention_hm_q_partial.launches += 1
    return out


paged_decode_attention_hm_q_partial.launches = 0


# ---------------------------------------------------------------------------
# MLA latent pool
# ---------------------------------------------------------------------------

def paged_mla_decode_plain(
    q_eff: torch.Tensor,         # [B, H, k_dim]: absorbed q_latent | q_pe
    latent_pool: torch.Tensor,   # [N, stored], stored >= k_dim
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    v_dim: int,
) -> torch.Tensor:
    k_dim = q_eff.shape[-1]
    ctx = latent_pool[slot_indices(page_tables, page_size)]  # [B, KV, stored]
    scores = torch.einsum("bhx,bsx->bhs", q_eff.float(), ctx[..., :k_dim].float()) * scale
    k_pos = torch.arange(ctx.shape[1], device=q_eff.device)[None, :]
    scores = torch.where((k_pos < context_lens[:, None])[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_eff.dtype)
    out = torch.einsum("bhs,bsv->bhv", probs.float(), ctx[..., :v_dim].float()).to(q_eff.dtype)
    return out.masked_fill((context_lens <= 0)[:, None, None], 0)


def paged_mla_decode_partial_plain(
    q_eff: torch.Tensor,         # [B, H, k_dim]
    latent_pool: torch.Tensor,   # [N, stored], stored >= k_dim
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int: pool tokens to attend over
    page_size: int,
    scale: float,
    v_dim: int,
):
    k_dim = q_eff.shape[-1]
    ctx = latent_pool[slot_indices(page_tables, page_size)]  # [B, KV, stored]
    scores = torch.einsum("bhx,bsx->bhs", q_eff.float(), ctx[..., :k_dim].float()) * scale
    k_pos = torch.arange(ctx.shape[1], device=q_eff.device)[None, :]
    m, l, p = _partial_probs(scores, (k_pos < context_lens[:, None])[:, None])
    return m, l, torch.einsum("bhs,bsv->bhv", p, ctx[..., :v_dim].float())


def _split_reference(scores: torch.Tensor, context_lens: torch.Tensor, splits: int) -> torch.Tensor:
    """The max each token's p is taken against in the latent kernel at
    ``splits`` context splits (csrc/mla_decode.cu): [0, ctx) cut into runs of
    one length, a multiple of 16 tokens, each walked in 64-token tiles with
    a running max (the tile's included). ``scores`` [B, H, KV], masked."""
    ref = torch.full_like(scores, NEG_INF)
    KV = scores.shape[-1]
    for b, ctx in enumerate(context_lens.tolist()):
        end = max(0, min(int(ctx), KV))
        per = -(-max(-(-end // splits), 1) // 16) * 16
        for lo in range(0, end, per):
            run = torch.full_like(scores[b, :, 0], NEG_INF)
            for t0 in range(lo, min(lo + per, end), 64):
                t1 = min(t0 + 64, lo + per, end)
                run = torch.maximum(run, scores[b, :, t0:t1].amax(-1))
                ref[b, :, t0:t1] = run[:, None]
    return ref


def paged_mla_decode_twin(
    q_eff: torch.Tensor,         # [B, H, k_dim]
    latent_pool: torch.Tensor,   # [N, stored], stored >= k_dim
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    v_dim: int,
    splits: int = 0,
) -> torch.Tensor:
    """The plain version in the kernels' rounding order (the TPU kernel's
    ``_kernel_hm`` in its latent mode, and the CUDA kernel's normal mode): the
    unnormalized ``p = exp(s - m)`` is rounded to the pool's dtype before P.V,
    ``l`` sums it unrounded, and the division by ``max(l, 1e-20)`` comes last;
    :func:`paged_mla_decode_plain` rounds the normalized probabilities, as
    the XLA path does. ``m`` is one max over the whole context (the TPU
    kernel's, when its pages fit one fetch group), or with ``splits`` > 0 the
    running max the CUDA kernel keeps at that split count
    (:func:`_split_reference`), each rounded p then rescaled in fp32 to the
    context's max, as the kernel's merge does."""
    k_dim = q_eff.shape[-1]
    ctx = latent_pool[slot_indices(page_tables, page_size)]  # [B, KV, stored]
    scores = torch.einsum("bhx,bsx->bhs", q_eff.float(), ctx[..., :k_dim].float()) * scale
    k_pos = torch.arange(ctx.shape[1], device=q_eff.device)[None, :]
    mask = (k_pos < context_lens[:, None])[:, None]
    m, l, p = _partial_probs(scores, mask)
    if splits:
        masked = torch.where(mask, scores, NEG_INF)
        ref = _split_reference(masked, context_lens, splits)
        p = torch.where(mask, torch.exp(masked - ref), 0.0)
        rescale = torch.where(mask, torch.exp(ref - m[..., None]), 0.0)
        p = p.to(latent_pool.dtype).float() * rescale
    else:
        p = p.to(latent_pool.dtype).float()
    acc = torch.einsum("bhs,bsv->bhv", p, ctx[..., :v_dim].float())
    return (acc / l.clamp_min(1e-20)[..., None]).to(q_eff.dtype)


def _entry_mla():
    fn = _build.library("mla_decode").zt_mla_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_longlong, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_mla_decode(
    q_eff: torch.Tensor,
    latent_pool: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    v_dim: int,
    emit_partial: bool = False,
):
    """MLA absorbed-weight latent decode as single-"head" MQA: scores are
    ``q_eff . latent[:k_dim]``, the output ``softmax(scores) . latent[:v_dim]``,
    [B, H, v_dim] in q's dtype; with ``emit_partial`` the flash partials
    (m, l, acc) instead."""
    args = (q_eff, latent_pool, page_tables, context_lens, page_size, scale, v_dim)
    if emit_partial:
        return paged_mla_decode_partial(*args)
    if q_eff.device.type == "cpu":
        return paged_mla_decode_plain(*args)
    out = _launch_mla("paged_mla_decode", *args, partial=False)
    paged_mla_decode.launches += 1
    return out


paged_mla_decode.launches = 0


def paged_mla_decode_partial(
    q_eff: torch.Tensor,
    latent_pool: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    v_dim: int,
):
    """Flash partials (m [B, H], l [B, H], acc [B, H, v_dim]) of the latent
    decode: the kernel of :func:`paged_mla_decode`, its merge writing the
    partials (the reference's ``emit_partial`` of ``_kernel_bs``)."""
    args = (q_eff, latent_pool, page_tables, context_lens, page_size, scale, v_dim)
    if q_eff.device.type == "cpu":
        return paged_mla_decode_partial_plain(*args)
    out = _launch_mla("paged_mla_decode_partial", *args, partial=True)
    paged_mla_decode_partial.launches += 1
    return out


paged_mla_decode_partial.launches = 0


def check_mla(what: str, q_eff, latent_pool, page_tables, context_lens, v_dim: int):
    """The latent kernel's shape, type and layout rules (shared with the
    fused mode); returns (B, H, k_dim, N, stored, maxp, fp16): q and the pool
    bf16, or both fp16."""
    if not q_eff.is_cuda:
        raise NotImplementedError(f"{what}: no kernel for device {q_eff.device}")
    B, H, k_dim = q_eff.shape
    if latent_pool.dim() != 2 or latent_pool.shape[1] < k_dim:
        raise ValueError(f"{what}: q {tuple(q_eff.shape)}, pool {tuple(latent_pool.shape)}")
    N, stored = latent_pool.shape
    fp16 = _build.elem_flag(f"{what} (q and pool)", q_eff, latent_pool)
    if (k_dim, v_dim) != (576, 512) or stored % 8:
        raise NotImplementedError(
            f"{what} kernel: k_dim {k_dim}, v_dim {v_dim}, row of {stored} elements "
            "(built for 576/512, rows a multiple of 16 bytes)")
    if page_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError(f"{what}: page_tables and context_lens must be int32")
    if page_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError(f"{what}: page_tables [B, maxp], context_lens [B]")
    for t in (q_eff, latent_pool, page_tables, context_lens):
        if t.device != q_eff.device or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and on one device")
    if latent_pool.data_ptr() % 16:
        raise ValueError(f"{what}: the pool must be 16-byte aligned")
    return B, H, k_dim, N, stored, page_tables.shape[1], fp16


# the latent kernel's split plan (csrc/mla_decode.cu): a power of two up to
# 16, the splits of a (sequence, head tile) launched as one cluster
_MLA_MAX_SPLITS = 16
_MLA_CLUSTERS: dict = {}


def mla_splits(B: int, H: int, max_ctx: int, capacity: int, clusters: dict) -> int:
    """The latent kernel's split count: as many as let every block fit on
    the card at once (:func:`decode_splits` over its blocks of 16 heads,
    ``capacity`` blocks), taken down to a power of two up to 16 for which the
    card holds a cluster per (sequence, head tile) at once (``clusters``:
    cluster size -> the clusters of that size the card holds)."""
    want = min(decode_splits(B, 1, H, max_ctx, capacity), _MLA_MAX_SPLITS)
    splits = 1 << (want.bit_length() - 1)
    while splits > 1 and clusters.get(splits, 0) < B * -(-H // _ROWS):
        splits //= 2
    return splits


def mla_plan(device, B: int, H: int, max_ctx: int) -> int:
    """:func:`mla_splits` on this device: the kernel's occupancy and the
    clusters of 2 to 16 blocks the card holds (a cluster's blocks share a
    GPC), asked once per device."""
    clusters = _MLA_CLUSTERS.get(device)
    if clusters is None:
        fn = _build.library("mla_decode").zt_mla_decode_max_clusters
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
        clusters = {}
        for cl in (2, 4, 8, 16):
            n = ctypes.c_int(0)
            _build.check(fn(cl, ctypes.byref(n)), "mla_decode clusters")
            clusters[cl] = n.value
        _MLA_CLUSTERS[device] = clusters
    return mla_splits(B, H, max_ctx, _capacity(device, 512, "mla_decode"), clusters)


def _launch_mla(what, q_eff, latent_pool, page_tables, context_lens, page_size, scale, v_dim,
                partial: bool, splits: int = 0):
    B, H, k_dim, N, stored, maxp, fp16 = check_mla(what, q_eff, latent_pool, page_tables,
                                                   context_lens, v_dim)
    splits = splits or mla_plan(q_eff.device, B, H, maxp * page_size)
    f32 = dict(dtype=torch.float32, device=q_eff.device)
    if partial:
        m, l = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
        acc = torch.empty((B, H, v_dim), **f32)
        result, ptrs = (m, l, acc), (acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        result = torch.empty((B, H, v_dim), dtype=q_eff.dtype, device=q_eff.device)
        ptrs = (result.data_ptr(), None, None)
    err = _entry_mla()(
        *ptrs, q_eff.data_ptr(), latent_pool.data_ptr(),
        page_tables.data_ptr(), context_lens.data_ptr(), B, H, k_dim, v_dim, N, stored, maxp,
        page_size, float(scale), splits, fp16, torch.cuda.current_stream(q_eff.device).cuda_stream,
    )
    _build.check(err, what)
    return result
