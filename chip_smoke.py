#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``zhilight_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py                   # every phase
    python3 chip_smoke.py --phases kernels  # a subset

It builds the port's CUDA kernels from ``zhilight_tpu_torch/csrc`` (one
``nvcc`` per source, all started together) and runs these phases:

  kernels  each CUDA kernel against its plain PyTorch version in bf16 at the
           shapes the main path gives it, and timed beside its bound, the
           plain version and one PyTorch library call (CUDA events, median);
  serve    the main path: ``LLM`` + ``DynamicBatchGenerator`` at the full
           MiniCPM-2B width (bench.py's configuration, random weights from a
           seed) answering 8 concurrent requests; every kernel's launch
           counter is set to 0 just before and read just after, and the
           first-token logits are held against a plain-path forward;
  timing   decode tokens/s (batch 16 at context 512; greedy, and sampled
           at temperature 0.8, top_p 0.9) and the time to first token of a
           3712-token prompt in 512-token chunks, by bench.py's method, then
           a torch.profiler breakdown of one decode window and one prefill.

The last lines are the kernels' JSON record, the GPU's name and power limit,
and ``{"ok": true, "device": {...}}``. Any failed phase makes the script exit
non-zero without the ``ok`` line; so does a machine without a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import operator
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
ATTN_TOL = 2e-2             # max |kernel - plain| on unit-variance bf16 inputs
LOGIT_TOL = 5e-2            # max |kernel - plain| logits / max |plain logits|

KERNELS = {
    "write_rows_hm": dict(
        source="zhilight_tpu_torch/csrc/kv_write.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:606",
    ),
    "paged_decode_attention_hm": dict(
        source="zhilight_tpu_torch/csrc/attn_headmajor.cu",
        replaces="zhilight_tpu/ops/pallas/attn_headmajor.py:151",
    ),
    "paged_prefill_attention_hm_packed": dict(
        source="zhilight_tpu_torch/csrc/prefill_attention.cu",
        replaces="zhilight_tpu/ops/pallas/prefill_attention.py:255",
    ),
}


def minicpm_2b():
    """MiniCPM-2B (``cpm_dragonfly``) at bench.py:107-121's geometry, full depth."""
    from zhilight_tpu_torch.config import ModelConfig

    return ModelConfig(
        model_type="cpm_dragonfly", num_layers=40, dim_model=2304,
        num_heads=36, dim_head=64, num_kv_heads=36, dim_ff=5760,
        vocab_size=122753, dtype="bfloat16", scale_emb=12.0, scale_depth=1.4,
        dim_model_base=256, tie_lm_head=True,
    )


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _paged(rng, context_lens, S, extra_pages=3):
    """Shuffled page tables ([B, maxp], -1 padded) covering context_lens."""
    B = len(context_lens)
    need = [(int(c) + S - 1) // S for c in context_lens]
    maxp = max(max(need), 1)
    P = sum(need) + extra_pages
    perm = rng.permutation(P).astype(np.int32)
    tables = np.full((B, maxp), -1, np.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o : o + n]
        o += n
    return tables, P


def _dev(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x)).cuda()
    return t.to(dtype) if dtype is not None else t


def _randn(rng, *shape):
    return _dev(rng.standard_normal(shape).astype(np.float32), torch.bfloat16)


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def phase_kernels(rec: dict) -> None:
    from zhilight_tpu_torch.kvcache.paged import gather_hm
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P

    F = torch.nn.functional
    rng = np.random.default_rng(0)
    S = 16

    # -- write_rows_hm: bit-exact against the plain scatter -------------------
    err = 0.0
    for T, start in ((16, None), (512, 3205)):
        H, D = 36, 64
        k, v = _randn(rng, T, H, D), _randn(rng, T, H, D)
        if start is None:  # decode: one row per sequence, one skipped
            npages = 64
            pages = rng.permutation(npages)[:T]
            slots = pages * S + rng.integers(0, S, T)
            slots[3] = -1
        else:  # a prefill chunk starting mid-page, through a shuffled table
            npages = (start + T) // S + 4
            table = rng.permutation(npages)
            pos = np.arange(start, start + T)
            slots = table[pos // S] * S + pos % S
        slots = _dev(slots.astype(np.int32))
        pool = _randn(rng, H, npages * S, 2 * D)
        got = W.write_rows_hm(pool.clone(), k, v, slots)
        want = W.write_rows_hm_plain(pool.clone(), k, v, slots)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"write_rows_hm T={T}: not bit-exact")
        print(f"kernels: write_rows_hm T={T} bit-exact", flush=True)
    # timed at the decode step's shape (B=16 rows of 36 heads x 64)
    T, H, D = 16, 36, 64
    k, v = _randn(rng, T, H, D), _randn(rng, T, H, D)
    slots = _dev((rng.permutation(256)[:T] * S).astype(np.int32))
    pool = _randn(rng, H, 256 * S, 2 * D)
    rows_hm = torch.cat([k, v], -1).transpose(0, 1).contiguous()
    idx = slots.long()
    ms = time_ms(lambda: W.write_rows_hm(pool, k, v, slots))
    rec["write_rows_hm"].update(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: W.write_rows_hm_plain(pool, k, v, slots)),
        # pool[:, idx] = rows: one index_put_ on rows already laid out head-major
        library_ms=time_ms(lambda: operator.setitem(pool, (slice(None), idx), rows_hm)),
    )
    t_b, by = bound(2 * T * H * 2 * D * 2 + T * 4, 0)
    rec["write_rows_hm"].update(bound_ms=t_b, bound_by=by)

    # -- paged_decode_attention_hm ------------------------------------------
    err = 0.0
    cases = [
        dict(B=16, Hq=36, Hkv=36, D=64, ctx_max=4096, window=0),
        dict(B=16, Hq=32, Hkv=8, D=128, ctx_max=4096, window=0),
        dict(B=16, Hq=36, Hkv=36, D=64, ctx_max=1024, window=100),
    ]
    for c in cases:
        B, Hq, Hkv, D = c["B"], c["Hq"], c["Hkv"], c["D"]
        ctx = rng.integers(1, c["ctx_max"] + 1, B).astype(np.int32)
        ctx[5] = 0  # an empty slot
        tables, npages = _paged(rng, ctx, S)
        pool = _randn(rng, Hkv, npages * S, 2 * D)
        q = _randn(rng, B, Hq, D)
        args = (q, pool, _dev(tables), _dev(ctx), S, 1.0 / np.sqrt(D), c["window"])
        got = A.paged_decode_attention_hm(*args)
        want = A.paged_decode_attention_hm_plain(*args)
        e = (got.float() - want.float()).abs().max().item()
        print(f"kernels: decode {c} max_abs_err={e:.3e}", flush=True)
        if not np.isfinite(e) or e > ATTN_TOL:
            raise AssertionError(f"decode attention {c}: max abs err {e} > {ATTN_TOL}")
        err = max(err, e)
    # timed at bench.py's decode shape: B=16, context 512, 36 heads of 64
    B, H, D, CTX = 16, 36, 64, 512
    maxp = CTX // S + 2
    tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
    pool = _randn(rng, H, B * maxp * S, 2 * D)
    q = _randn(rng, B, H, D)
    ctx = _dev(np.full(B, CTX, np.int32))
    args = (q, pool, _dev(tables), ctx, S, 1.0 / np.sqrt(D))
    k, v = gather_hm(pool, _dev(tables), S)  # [B, KV, H, D]
    kg = k[:, :CTX].transpose(1, 2).contiguous()
    vg = v[:, :CTX].transpose(1, 2).contiguous()
    rec["paged_decode_attention_hm"].update(
        max_abs_err=err,
        ms=time_ms(lambda: A.paged_decode_attention_hm(*args)),
        plain_ms=time_ms(lambda: A.paged_decode_attention_hm_plain(*args)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg)),
    )
    nbytes = B * CTX * H * 2 * D * 2 + 2 * q.numel() * 2 + tables.size * 4 + B * 4
    t_b, by = bound(nbytes, 4 * B * H * CTX * D)
    rec["paged_decode_attention_hm"].update(bound_ms=t_b, bound_by=by)

    # -- paged_prefill_attention_hm_packed ----------------------------------
    err = 0.0
    H, D = 36, 64
    cases = [
        dict(cache_lens=[0], q_lens=[512], TC=512),
        dict(cache_lens=[3205], q_lens=[512], TC=512),
        dict(cache_lens=[0, 16, 5, 300], q_lens=[128, 37, 0, 100], TC=128),
    ]
    for c in cases:
        cl = np.array(c["cache_lens"], np.int32)
        ql = np.array(c["q_lens"], np.int32)
        NS, TC = len(cl), c["TC"]
        tables, npages = _paged(rng, cl + ql, S)
        pool = _randn(rng, H, npages * S, 2 * D)
        q = _randn(rng, NS * TC, H, D)
        args = (q, pool, _dev(tables), _dev(cl), _dev(ql), S, 1.0 / np.sqrt(D))
        got = P.paged_prefill_attention_hm_packed(*args)
        want = P.paged_prefill_attention_hm_packed_plain(*args)
        if not torch.isfinite(got).all():
            raise AssertionError(f"prefill attention {c}: non-finite output")
        e = 0.0
        for s in range(NS):
            rows = slice(s * TC, s * TC + int(ql[s]))
            if ql[s]:
                e = max(e, (got[rows].float() - want[rows].float()).abs().max().item())
        print(f"kernels: prefill {c} max_abs_err={e:.3e}", flush=True)
        if e > ATTN_TOL:
            raise AssertionError(f"prefill attention {c}: max abs err {e} > {ATTN_TOL}")
        err = max(err, e)
    # timed at the time-to-first-token shape: a 512-token chunk at context 3200
    CL, QL = 3200, 512
    tables, npages = _paged(rng, [CL + QL], S)
    pool = _randn(rng, H, npages * S, 2 * D)
    q = _randn(rng, QL, H, D)
    args = (q, pool, _dev(tables), _dev(np.array([CL], np.int32)),
            _dev(np.array([QL], np.int32)), S, 1.0 / np.sqrt(D))
    k, v = gather_hm(pool, _dev(tables[0]), S)  # [KV, H, D]
    kg = k[: CL + QL].transpose(0, 1)[None].contiguous()
    vg = v[: CL + QL].transpose(0, 1)[None].contiguous()
    qg = q.transpose(0, 1)[None].contiguous()
    mask = (torch.arange(CL + QL, device="cuda")[None, :]
            <= CL + torch.arange(QL, device="cuda")[:, None])
    rec["paged_prefill_attention_hm_packed"].update(
        max_abs_err=err,
        ms=time_ms(lambda: P.paged_prefill_attention_hm_packed(*args)),
        plain_ms=time_ms(lambda: P.paged_prefill_attention_hm_packed_plain(*args), reps=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)),
    )
    keys = sum(CL + i + 1 for i in range(QL))
    nbytes = (CL + QL) * H * 2 * D * 2 + 2 * q.numel() * 2
    t_b, by = bound(nbytes, 4 * H * D * keys)
    rec["paged_prefill_attention_hm_packed"].update(bound_ms=t_b, bound_by=by)
    for name in KERNELS:
        r = rec[name]
        print(f"kernels: {name} ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f}", flush=True)


# ---------------------------------------------------------------------------
# phase: serve (the main path)
# ---------------------------------------------------------------------------

def _counters():
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P

    return {
        "write_rows_hm": W.write_rows_hm,
        "paged_decode_attention_hm": A.paged_decode_attention_hm,
        "paged_prefill_attention_hm_packed": P.paged_prefill_attention_hm_packed,
    }


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions, by replacing
    the kernel modules that the model and the KV cache call through (for
    this script's plain-path reference forward only)."""
    from types import SimpleNamespace
    from unittest import mock

    from zhilight_tpu_torch.kvcache import paged as paged_mod
    from zhilight_tpu_torch.models import llama as llama_mod
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P

    def prefill_single(q, pool, table, cache_len, q_len, S, scale, sw=0):
        return P.paged_prefill_attention_hm_packed_plain(
            q, pool, table.reshape(1, -1), cache_len.reshape(1), q_len.reshape(1), S, scale, sw)

    with mock.patch.object(paged_mod, "kv_write",
                           SimpleNamespace(write_rows_hm=W.write_rows_hm_plain)), \
         mock.patch.object(llama_mod, "attn_headmajor",
                           SimpleNamespace(paged_decode_attention_hm=A.paged_decode_attention_hm_plain)), \
         mock.patch.object(llama_mod, "prefill_attention", SimpleNamespace(
             paged_prefill_attention_hm=prefill_single,
             paged_prefill_attention_hm_packed=P.paged_prefill_attention_hm_packed_plain)):
        yield


def _prefill_logits(ex, prompt):
    """Last-token logits [V] of one prompt through the model's forward on a
    scratch cache (identity page table)."""
    from zhilight_tpu_torch.kvcache.paged import new_kv_cache
    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.models.base import PrefillMeta

    cfg, S, n = ex.cfg, ex.page_size, len(prompt)
    pages = (n + S - 1) // S
    cache = new_kv_cache(cfg.num_layers, pages, S, cfg.num_kv_heads, cfg.dim_head,
                         cfg.torch_dtype, device=ex.device)
    i32 = dict(dtype=torch.int32, device=ex.device)
    meta = PrefillMeta(
        positions=torch.arange(n, **i32), slot_mapping=torch.arange(n, **i32),
        page_table=torch.arange(pages, **i32), cache_len=torch.tensor(0, **i32),
        q_len=torch.tensor(n, **i32),
    )
    with torch.no_grad():
        logits, _ = L.forward_prefill(ex.params, cfg, ex.rope,
                                      torch.tensor(prompt, **i32), meta, cache)
    return logits


def phase_serve(rec: dict, args) -> None:
    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L

    cfg = minicpm_2b()
    t0 = time.monotonic()
    params = L.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    ecfg = EngineConfig(
        max_model_len=4096,
        cache=CacheConfig(page_size=16),
        scheduler=SchedulerConfig(max_batch=16, chunk_size=512),
    )
    llm = LLM(model_config=cfg, params=params, engine_config=ecfg, device="cuda")
    ex = llm.executor
    warm_s = ex.warmup()
    print(f"serve: MiniCPM-2B {cfg.num_layers} layers, {L.param_count(params) / 1e9:.3f} B params, "
          f"{ex.num_pages} KV pages, decode window {ex.decode_window}, "
          f"set-up {time.monotonic() - t0:.1f} s (warmup {warm_s:.1f} s), "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)

    rng = np.random.default_rng(args.seed)
    lens = [7, 100, 513, 1500, 3712, 16, 250, 40]
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]
    MAXLEN = 32
    gargs = [GeneratorArg(max_length=MAXLEN) for _ in lens]
    gargs[1] = GeneratorArg(max_length=MAXLEN, temperature=0.8, top_p=0.9, seed=7)
    gargs[6] = GeneratorArg(max_length=MAXLEN, temperature=0.8, top_p=0.9, seed=11)

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    gen = DynamicBatchGenerator(llm).start()
    try:
        t0 = time.monotonic()
        results = gen.batch_generate(prompts, gargs, timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        solo = [gen.generate(prompts[0], GeneratorArg(max_length=MAXLEN), timeout=300)
                for _ in range(2)]
    finally:
        gen.stop()
    for name, n in launches.items():
        rec[name]["launches"] = n
    print(f"serve: {len(prompts)} requests in {wall:.2f} s; launches {launches}", flush=True)
    for n, a, r in zip(lens, gargs, results):
        out = r.outputs[0]
        print(f"serve: prompt {n} temp {a.temperature}: {len(out.token_ids)} tokens, "
              f"finish {out.finish_reason}, first tokens {out.token_ids[:6]}", flush=True)
        if not (len(out.token_ids) == MAXLEN or out.finish_reason == "stop"):
            raise AssertionError(f"prompt {n}: {len(out.token_ids)} tokens, {out.finish_reason}")
        if out.logprobs is None or not np.all(np.isfinite(out.logprobs)):
            raise AssertionError(f"prompt {n}: non-finite logprobs")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if solo[0].outputs[0].token_ids != solo[1].outputs[0].token_ids:
        raise AssertionError("a repeated greedy request returned other tokens")
    same = sum(a == b for a, b in zip(solo[0].outputs[0].token_ids, results[0].outputs[0].token_ids))
    print(f"serve: repeated greedy request identical; agrees with its batched run "
          f"on {same}/{MAXLEN} tokens", flush=True)

    # first-token logits: main path (kernels) against the plain path, on the card
    prompt = prompts[1]
    got = _prefill_logits(ex, prompt)
    with plain_kernels():
        want = _prefill_logits(ex, prompt)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite first-token logits")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top_k, top_p = torch.topk(got, 5).indices.tolist(), torch.topk(want, 5).indices.tolist()
    print(f"serve: first-token logits kernel vs plain: max rel err {rel:.3e} "
          f"(tolerance {LOGIT_TOL}); argmax {top_k[0]} vs {top_p[0]}; "
          f"top-5 overlap {len(set(top_k) & set(top_p))}/5", flush=True)
    if rel > LOGIT_TOL:
        raise AssertionError(f"first-token logits differ: {rel} > {LOGIT_TOL}")
    args.llm = llm


# ---------------------------------------------------------------------------
# phase: timing (bench.py's method)
# ---------------------------------------------------------------------------

def phase_timing(rec: dict, args, smi: str) -> None:
    from zhilight_tpu_torch.models.base import PrefillMeta
    from zhilight_tpu_torch.ops.sampling import SamplingParams

    ex = args.llm.executor
    dev = ex.device
    S, BATCH, CTX, WINDOWS = ex.page_size, 16, 512, 10
    MAX_PAGES = CTX // S + 2
    K = ex.decode_window
    page_tables = np.stack([b * MAX_PAGES + np.arange(MAX_PAGES) for b in range(BATCH)]).astype(np.int32)
    positions = np.full(BATCH, CTX - 1, np.int32)
    context_lens = np.full(BATCH, CTX, np.int32)
    limits = np.full(BATCH, MAX_PAGES * S - 1, np.int32)
    tokens = np.zeros(BATCH, np.int32)
    greedy = SamplingParams.greedy(BATCH, device=dev)
    sampled = SamplingParams.greedy(BATCH, device=dev)
    sampled.temperature.fill_(0.8)
    sampled.top_p.fill_(0.9)

    def run(sp=greedy, **kw):
        return ex.run_decode_multi(tokens, page_tables, positions, context_lens, limits, sp, K,
                                   greedy_only=sp is greedy, **kw)

    def decode_tok_s(sp):
        run(sp)
        t0 = time.perf_counter()
        pending = None
        for _ in range(WINDOWS):
            handle = run(sp, reuse_carry=True, fetch=False)
            if pending is not None:
                ex.fetch(pending)
            pending = handle
        ex.fetch(pending)
        return BATCH * K * WINDOWS / (time.perf_counter() - t0)

    tok_s = decode_tok_s(greedy)
    sampled_tok_s = decode_tok_s(sampled)

    PROMPT, CHUNK = 3712, 512
    n_chunks = (PROMPT + CHUNK - 1) // CHUNK
    n_pages = (PROMPT + 1 + S - 1) // S
    prompt = np.random.RandomState(0).randint(2, 1000, PROMPT).astype(np.int32)
    sp1 = SamplingParams.greedy(1, device=dev)
    pt_np = np.full(ex.max_pages_per_seq, -1, np.int32)
    pt_np[:n_pages] = np.arange(n_pages)
    pt_dev = torch.from_numpy(pt_np).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def prefill_once():
        c = 0
        while c < n_chunks:
            start = c * CHUNK
            chunk = min(CHUNK, PROMPT - start)
            is_last = c + 1 == n_chunks
            chainable = (n_chunks - 1) - c
            if not is_last and chunk == CHUNK and chainable >= 2:
                C = next((x for x in ex.CHAIN_SIZES if x <= chainable), None)
                if C is not None:
                    ex.run_chunk_chain(prompt[start : start + C * CHUNK].reshape(C, CHUNK), pt_dev, start)
                    c += C
                    continue
            bucket = ex.pick_bucket(chunk)
            toks = np.zeros(bucket, np.int32)
            toks[:chunk] = prompt[start : start + chunk]
            if not is_last:
                ex.run_chunk_fused(toks, pt_dev, start, chunk)
                c += 1
                continue
            pos = np.zeros(bucket, np.int32)
            pos[:chunk] = np.arange(start, start + chunk)
            slots = np.full(bucket, -1, np.int32)
            slots[:chunk] = np.arange(start, start + chunk)
            meta = PrefillMeta(
                positions=torch.from_numpy(pos).to(dev),
                slot_mapping=torch.from_numpy(slots).to(dev),
                page_table=pt_dev, cache_len=torch.tensor(start, **i32),
                q_len=torch.tensor(chunk, **i32),
            )
            tok, _, _, _ = ex.run_prefill(toks, meta, sp1, 0, 0)
            c += 1
        return tok

    prefill_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_once()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    print(f"timing: decode {tok_s:.2f} tok/s greedy, {sampled_tok_s:.2f} tok/s sampled "
          f"(temperature 0.8, top_p 0.9) (batch {BATCH}, context {CTX}, window {K}, "
          f"{WINDOWS} windows); TTFT {ttft_ms:.2f} ms (prompt {PROMPT}, chunk {CHUNK}); "
          f"{ex.cfg.num_layers} layers; {smi}", flush=True)
    print(json.dumps({"decode_tok_s": tok_s, "sampled_decode_tok_s": sampled_tok_s,
                      "ttft_ms": ttft_ms, "gpu": smi}), flush=True)

    # where the time goes: one traced decode window and one traced prefill,
    # after the timed runs (the trace does not touch the numbers above)
    profile("decode window", lambda: run(reuse_carry=True))
    profile("prefill 3712", prefill_once)


def profile(what: str, fn) -> None:
    """Device busy share and the kernels that take most device time in one
    traced call (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    print(f"profile: {what}: wall {wall_ms:.2f} ms (traced), device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events)} kernels", flush=True)
    for e in top:
        print(f"profile: {what}:   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,serve,timing")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here", file=sys.stderr)
        return 1
    from zhilight_tpu_torch.ops.cuda import _build

    smi = nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    _build.build_all()
    print(f"build: 3 CUDA libraries in {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)
    print("kernels: " + ", ".join(f"{k} ({v['source']})" for k, v in KERNELS.items()), flush=True)

    rec = {name: dict(name=name, route="cuda", **meta, launches=0, max_abs_err=None,
                      ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                      library_ms=None)
           for name, meta in KERNELS.items()}
    failed = []
    for phase in phases:
        try:
            if phase == "kernels":
                phase_kernels(rec)
            elif phase == "serve":
                phase_serve(rec, args)
            elif phase == "timing":
                phase_timing(rec, args, smi)
            else:
                raise ValueError(f"unknown phase {phase!r}")
        except Exception:
            traceback.print_exc()
            print(f"phase {phase}: FAILED", flush=True)
            failed.append(phase)
    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
