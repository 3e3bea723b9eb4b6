"""Checkpoint-side quantization conversion (counterpart of
``zhilight_tpu/utils/quant_convert.py``).

The packed int32 checkpoint tensors are unpacked once, at load, into the
canonical int4 format of ``ops/quant.py`` (nibble values in int8, groupwise
f32 scales and zeros), or, for GPTQ without act-order, straight into the
global-planar uint8 layout the ``w4a16_matmul`` kernel reads. Arrays in and
out are numpy and the bit operations run in torch on the host, except
:func:`planar_from_gptq`, which runs on any device. The results are
bit-identical to the reference's.

Packing conventions:
  GPTQ v1 (AutoGPTQ): qweight int32 [K/8, N], nibble j = input row i*8+j
    (little-endian); qzeros int32 [G, N/8] holding zero - 1; scales [G, N];
    optional g_idx [K] for act-order.
  AWQ (AutoAWQ "gemm"): qweight int32 [K, N/8], nibble j = output column
    i*8 + AWQ_ORDER[j] with AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7); qzeros
    packed the same way, no offset; scales [G, N].

W8A8 at load (:func:`auto_int8_from_fp`, :func:`smooth_quant_weights`,
:func:`quantize_int8_params`) takes and returns torch tensors on the weights'
own device; the arithmetic is fp32 in the reference's order, so ``w_q`` is
bit-equal to the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.quant import quantize_int8_weight

__all__ = [
    "unpack_gptq",
    "unpack_awq",
    "pack_gptq",
    "pack_awq",
    "gptq_planar_qweight",
    "planar_from_gptq",
    "convert_quant_tensors",
    "auto_int8_from_fp",
    "smooth_quant_weights",
    "quantize_int8_params",
]

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _unpack_rows_le(q: np.ndarray) -> np.ndarray:
    """int32 [R, N] -> int8 [R*8, N]: little-endian 4-bit fields along rows."""
    R, N = q.shape
    tq = torch.from_numpy(np.ascontiguousarray(q))
    out = torch.empty((R, 8, N), dtype=torch.int8)
    for j in range(8):
        out[:, j, :] = (tq >> (4 * j)) & 0xF
    return out.reshape(R * 8, N).numpy()


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------

def unpack_gptq(
    qweight: np.ndarray,  # int32 [K/8, N]
    qzeros: np.ndarray,  # int32 [G, N/8]
    scales: np.ndarray,  # [G, N]
    g_idx: Optional[np.ndarray] = None,  # [K]
) -> Dict[str, np.ndarray]:
    """Returns canonical {"w_p" int8 [K, N], "scales" f32, "zeros" f32, "perm"?}."""
    Kp, N = qweight.shape
    K = Kp * 8
    G = scales.shape[0]

    w_p = _unpack_rows_le(qweight)

    zshifts = (np.arange(8, dtype=np.uint32) * 4)[None, None, :]
    z = ((qzeros.astype(np.uint32)[:, :, None] >> zshifts) & 0xF).reshape(G, -1)
    zeros = z.astype(np.float32) + 1.0  # AutoGPTQ v1 stores zero - 1

    out = {"w_p": w_p, "scales": scales.astype(np.float32), "zeros": zeros}
    if g_idx is not None and len(g_idx):
        gs = K // G
        if not np.array_equal(g_idx, np.arange(K) // gs):
            # act-order: sort the rows so each group is contiguous; the
            # activations are gathered with the same permutation at run time
            perm = np.argsort(g_idx, kind="stable")
            out["w_p"] = np.ascontiguousarray(w_p[perm])
            out["perm"] = perm.astype(np.int32)
    return out


_PACK_FORMAT_CHECKED = False


def _assert_pack_format():
    """One-time guard: gptq_planar_qweight re-derives ops.quant.pack_int4's
    layout (INT4_PACK_FORMAT) without calling it; check the version and a
    round trip, so an encoding change in either place fails loudly."""
    global _PACK_FORMAT_CHECKED
    if _PACK_FORMAT_CHECKED:
        return
    from ..ops.quant import INT4_PACK_FORMAT, pack_int4

    if INT4_PACK_FORMAT != 2:
        raise RuntimeError(
            f"quant_convert implements packed-int4 format v2 but ops.quant "
            f"declares v{INT4_PACK_FORMAT}; update gptq_planar_qweight"
        )
    probe = np.arange(16, dtype=np.int8).reshape(16, 1) % 16
    if not np.array_equal(_planar_pack_reference(probe), pack_int4(torch.from_numpy(probe)).numpy()):
        raise RuntimeError("gptq_planar_qweight layout diverged from pack_int4")
    _PACK_FORMAT_CHECKED = True


def _planar_pack_reference(w_nib: np.ndarray) -> np.ndarray:
    """Numpy mirror of ops.quant.pack_int4 (format v2) for the guard above."""
    K = w_nib.shape[0]
    lo = w_nib[: K // 2].astype(np.uint8)
    hi = w_nib[K // 2 :].astype(np.uint8) ^ 8
    return lo | (hi << 4)


def planar_from_gptq(qweight: torch.Tensor) -> torch.Tensor:
    """GPTQ qweight int32 [K/8, N] -> planar-packed uint8 [K/2, N] directly,
    on the tensor's own device (the loader runs it on the GPU when it
    loads to one).

    Same output as ``pack_int4(unpack_gptq(...)["w_p"])`` without the int8
    [K, N] intermediate. Valid only without an act-order permutation."""
    _assert_pack_format()
    Kp, N = qweight.shape  # Kp = K/8
    half = Kp // 2

    def nibbles(q):
        # int32 [half, N] as little-endian bytes [half, N, 4]: byte b of
        # element (k, n) holds rows 8k+2b (low nibble) and 8k+2b+1 (high)
        b = q.contiguous().view(torch.uint8).reshape(half, N, 4)
        return b & 0xF, b >> 4

    even_lo, odd_lo = nibbles(qweight[:half])
    even_hi, odd_hi = nibbles(qweight[half:])
    res_even = even_lo | ((even_hi ^ 8) << 4)  # planar rows 8k + {0, 2, 4, 6}
    res_odd = odd_lo | ((odd_hi ^ 8) << 4)  # planar rows 8k + {1, 3, 5, 7}
    out = torch.stack([res_even, res_odd], dim=3)  # [half, N, 4, 2]
    return out.permute(0, 2, 3, 1).reshape(half * 8, N).contiguous()


def gptq_planar_qweight(qweight: np.ndarray) -> np.ndarray:
    """:func:`planar_from_gptq` on the host, numpy in and out."""
    return planar_from_gptq(torch.from_numpy(np.ascontiguousarray(qweight))).numpy()


def pack_gptq(
    w_p: np.ndarray, zeros: np.ndarray, scales: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of unpack_gptq (tests and export)."""
    K, N = w_p.shape
    G = scales.shape[0]
    w = w_p.astype(np.uint32).reshape(K // 8, 8, N)
    qweight = np.zeros((K // 8, N), np.uint32)
    for j in range(8):
        qweight |= w[:, j, :] << (4 * j)
    z = (zeros.astype(np.uint32) - 1).reshape(G, N // 8, 8)
    qzeros = np.zeros((G, N // 8), np.uint32)
    for j in range(8):
        qzeros |= z[:, :, j] << (4 * j)
    return qweight.astype(np.int32), qzeros.astype(np.int32), scales


# ---------------------------------------------------------------------------
# AWQ
# ---------------------------------------------------------------------------

def unpack_awq(
    qweight: np.ndarray,  # int32 [K, N/8]
    qzeros: np.ndarray,  # int32 [G, N/8]
    scales: np.ndarray,  # [G, N]
) -> Dict[str, np.ndarray]:
    K, Np = qweight.shape
    N = Np * 8

    def unpack_cols(a):
        ta = torch.from_numpy(np.ascontiguousarray(a))
        out = torch.empty((a.shape[0], Np, 8), dtype=torch.uint8)
        for j, col in enumerate(AWQ_ORDER):
            out[:, :, col] = (ta >> (4 * j)) & 0xF
        return out.reshape(a.shape[0], N).numpy()

    return {
        "w_p": unpack_cols(qweight).astype(np.int8),
        "zeros": unpack_cols(qzeros).astype(np.float32),
        "scales": scales.astype(np.float32),
    }


def pack_awq(
    w_p: np.ndarray, zeros: np.ndarray, scales: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    K, N = w_p.shape

    def pack_cols(a):
        v = a.astype(np.uint32).reshape(a.shape[0], N // 8, 8)
        out = np.zeros((a.shape[0], N // 8), np.uint32)
        for j, col in enumerate(AWQ_ORDER):
            out |= v[:, :, col] << (4 * j)
        return out.astype(np.int32)

    return pack_cols(w_p), pack_cols(zeros), scales


# ---------------------------------------------------------------------------
# dict-level conversion
# ---------------------------------------------------------------------------

def convert_quant_tensors(
    tensors: Dict[str, np.ndarray], method: str
) -> Optional[Dict[str, np.ndarray]]:
    """Convert one linear's {qweight, qzeros, scales, g_idx?} to canonical."""
    if "qweight" not in tensors:
        return None
    if method == "gptq":
        return unpack_gptq(
            tensors["qweight"], tensors["qzeros"], tensors["scales"], tensors.get("g_idx")
        )
    if method == "awq":
        return unpack_awq(tensors["qweight"], tensors["qzeros"], tensors["scales"])
    raise ValueError(f"unknown quant method {method!r}")


# ---------------------------------------------------------------------------
# int8 at load
# ---------------------------------------------------------------------------

def auto_int8_from_fp(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel absmax int8. w [in, out] -> {"w_q" int8, "scale" f32 [out]}."""
    w_q, scale = quantize_int8_weight(w)
    return {"w_q": w_q, "scale": scale}


def smooth_quant_weights(
    w: torch.Tensor, act_scale, alpha: float = 0.5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SmoothQuant migration: returns (w * s[:, None], 1 / s) with
    s = act_scale^alpha / w_rowmax^(1 - alpha), all fp32. The runtime
    multiplies the activations by the returned ``smooth`` (= 1 / s) vector.
    The [in] vector s is computed with numpy on the host, in the reference's
    order (the libraries' ``pow`` differ in the last bit); the weight stays
    on its device."""
    wf = w.float()
    if isinstance(act_scale, torch.Tensor):
        act_scale = act_scale.detach().cpu().numpy()
    act = np.asarray(act_scale, np.float32)
    w_amax = np.maximum(wf.abs().amax(1).cpu().numpy(), 1e-8)
    s = np.power(np.maximum(act, 1e-8), alpha) / np.power(w_amax, 1.0 - alpha)
    s = np.maximum(s, 1e-8).astype(np.float32)
    smooth = torch.from_numpy((1.0 / s).astype(np.float32)).to(wf.device)
    return wf * torch.from_numpy(s).to(wf.device)[:, None], smooth


_INT8_TARGETS = (
    "qkv_proj", "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_up_proj", "gate_proj", "up_proj", "down_proj",
)


def quantize_int8_params(
    params: Dict[str, Any],
    act_scales: Optional[Dict[str, Any]] = None,
    alpha: float = 0.5,
) -> Dict[str, Any]:
    """Quantize the dense-layer linears of a loaded parameter tree to W8A8
    int8 in place of their ``{"w"}`` leaves (2-D weights only; expert stacks
    are skipped; a bias is kept). With ``act_scales`` (from
    ``utils.calibrate.calc_act_scales``, keyed by parameter path) the
    SmoothQuant migration folds activation outliers into the weights and
    stores the inverse ``smooth`` vector for ``ops.quant.int8_linear``.
    Embedding, lm_head, norms, routers and leaves that are quantized already
    are untouched. Returns a new tree; the leaves stay on their device."""

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            sub = f"{path}.{k}" if path else k
            if not isinstance(v, dict):
                out[k] = v
            elif (k in _INT8_TARGETS and "w" in v and ".experts" not in sub
                  and getattr(v["w"], "ndim", 0) == 2):
                w, smooth = v["w"].float(), None
                if act_scales is not None and sub in act_scales:
                    w, smooth = smooth_quant_weights(w, act_scales[sub], alpha)
                new = auto_int8_from_fp(w)
                if smooth is not None:
                    new["smooth"] = smooth
                if "b" in v:
                    new["b"] = v["b"]
                out[k] = new
            else:
                out[k] = walk(v, sub)
        return out

    return walk(params, "")
