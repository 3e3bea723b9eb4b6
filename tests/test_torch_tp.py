"""Tensor parallelism of the port (zhilight_tpu_torch) on the CPU: one
process a rank, joined by a gloo group, held against the single-process port
and against the JAX package's ``ParallelConfig(tp=N)`` on the 8 virtual CPU
devices of tests/conftest.py.

- The rule table: ``param_shard_dim`` gives the dim that the reference's
  ``param_pspec`` shards, on every leaf of dense llama, qwen2 (biases),
  MiniCPM, MoE and MLA trees, a layer-stacked tree and quantized leaves.
- The forward, as tests/test_tensor_parallel.py holds it: a prefill chunk and
  one decode step at TP=2 and TP=4 against the single-process port and the
  JAX forward on a tp mesh, within 2e-4 in fp32.
- The engine: the port's greedy tokens at TP=2 against the JAX engine's at
  ``ParallelConfig(tp=2)`` over the packed head-major pool, slot-major pools
  (head_dim 16), the int8 pool, ``ZT_WINDOW_KV=1``, and swap and recompute
  preemption, the last also with a pool budget of each rank's own, on which
  the ranks agree; both ranks finish every request with the same tokens, a
  seeded sampled one included; a session's close and a cancel are replayed
  on rank 1, which stops on rank 0's shutdown sentinel.
- The server: ``api_server --tensor-parallel 2`` as two processes with
  torchrun's variables: rank 0 answers ``/v1/completions`` with tp=1's text
  and usage; rank 1 binds no port.
- The raises: a vocab, KV-head count or ``dim_ff`` that tp does not divide;
  a world that is not tp; tp > 1 without a process group; scoring and
  calibration under tp > 1. Quantized linears under tp > 1, which once
  raised here, build (tests/test_torch_tp_quant.py serves them).

MoE and MLA under tensor parallelism are tests/test_torch_tp_moe.py's, on
this file's rank processes (:class:`Ranks`, ``RANK``), which also record
every routing's expert ids and the collectives a MoE layer issues.

The rank processes import torch and the port only (the weights come from the
JAX package's ``init_params`` through an ``.npz``), started as
tests/test_multihost_engine.py starts its hosts: every one has a
``communicate`` timeout and its default process group a 60 s timeout, so a
hang fails the test in under two minutes. One pair of ranks runs every engine
case, one pair and one quartet every forward case, in the background while
the JAX side runs in this process.
"""

import asyncio
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import MLAConfig as JMLAConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import MoEConfig as JMoEConfig
from zhilight_tpu.config import ParallelConfig as JParallelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.kvcache import new_kv_cache as j_new_kv_cache
from zhilight_tpu.kvcache import new_latent_cache as j_new_latent_cache
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models import stacked as JS
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu.parallel import TP_AXIS, make_mesh
from zhilight_tpu.parallel import shard_params as j_shard_params
from zhilight_tpu.parallel.sharding import param_pspec
from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig,
                                       ParallelConfig, QuantConfig, QuantType,
                                       SchedulerConfig)
from zhilight_tpu_torch.kvcache.paged import new_kv_cache, new_latent_cache
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta
from zhilight_tpu_torch.parallel.comm import LAUNCH_VARS, local_device
from zhilight_tpu_torch.parallel.sharding import check_tp, is_shard, param_shard_dim, shard_params
from zhilight_tpu_torch.utils.convert import params_to_torch

import torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 110  # seconds a rank process may take; its default group times out after 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _params(jcfg, seed=0, biases=False):
    """The JAX package's random weights as numpy; with ``biases`` every
    linear gets a random bias (row-parallel ones included)."""
    params = jax.device_get(JL.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    if biases:
        rng = np.random.RandomState(seed + 3)
        for layer in params["layers"].values():
            for group in (layer["attn"], layer["mlp"]):
                for p in group.values():
                    if isinstance(p, dict) and "w" in p:
                        p["b"] = (rng.randn(p["w"].shape[1]) * 0.5).astype(np.float32)
    return params


def _save(params, path):
    np.savez(path, **{k: np.asarray(v) for k, v in _flat(params)})
    return str(path)


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

RANK = r"""
import datetime, hashlib, json, os, sys, threading, time
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
spec_path, rank, world, port, out_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
spec = json.load(open(spec_path))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))

from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, MLAConfig, ModelConfig,
                                       MoEConfig, ParallelConfig, RopeConfig, SchedulerConfig)
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.engine.engine import ModelExecutor
from zhilight_tpu_torch.engine.session import SessionGenerator
from zhilight_tpu_torch.engine.task import SearchTask, StreamResultType
from zhilight_tpu_torch.kvcache.paged import new_kv_cache, new_latent_cache
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as L
from zhilight_tpu_torch.models import moe as M
from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta
from zhilight_tpu_torch.parallel.comm import TPGroup
from zhilight_tpu_torch.parallel.sharding import rank_config, shard_params
from zhilight_tpu_torch.utils.convert import params_to_torch
from zhilight_tpu_torch.utils.hf_loader import map_hf_params
from zhilight_tpu_torch.utils.quant_convert import quantize_int8_params


def flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, path)
        else:
            yield path, v


def model_config(m):
    # a ModelConfig from its fields, MLA, MoE and rope as nested dicts
    m = dict(m)
    for key, kind in (("mla", MLAConfig), ("moe", MoEConfig), ("rope", RopeConfig)):
        if isinstance(m.get(key), dict):
            m[key] = kind(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in m[key].items()})
    return ModelConfig(**m)


def load(path):
    # FP8 payloads are saved as their bytes (uint8)
    tree = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parts, leaf = key.split(".")
            for part in parts:
                node = node.setdefault(part, {})
            value = flat[key]
            node[leaf] = (torch.from_numpy(value).view(torch.float8_e4m3fn) if leaf == "w_f8"
                          else value)
    return tree


finished = {}
_finish, _finish_multi = SearchTask.finish, SearchTask.finish_multi
def _patched(self):
    finished[str(self.task_id)] = list(map(int, self.output_tokens))
    _finish(self)
def _patched_multi(self, outs):
    finished[str(self.task_id)] = [list(map(int, o.token_ids)) for o in outs]
    _finish_multi(self, outs)
SearchTask.finish, SearchTask.finish_multi = _patched, _patched_multi

window_steps = [0]
_window = L.forward_decode_window
def _counted(*a, **kw):
    window_steps[0] += 1
    return _window(*a, **kw)
L.forward_decode_window = _counted

# the expert ids of every routing, and the shape of every collective issued
# (inside a MoE layer, and in all)
routed, moe_collectives, in_moe, collectives = [], [], [False], []
_select = M.select_experts
def _routing(*a, **kw):
    weights, ids = _select(*a, **kw)
    routed.append(ids.tolist())
    return weights, ids
M.select_experts = _routing
_moe_layer = M.moe_layer
def _in_moe(*a, **kw):
    in_moe[0] = True
    try:
        return _moe_layer(*a, **kw)
    finally:
        in_moe[0] = False
M.moe_layer = _in_moe
for op in ("all_reduce", "all_gather"):
    def _recorded(self, x, *a, _fn=getattr(TPGroup, op), _op=op, **kw):
        what = [_op, str(x.dtype), list(x.shape), "max" if "MAX" in str(kw.get("op")) else "sum"]
        if in_moe[0]:
            moe_collectives.append(what[:3])
        collectives.append(what)
        return _fn(self, x, *a, **kw)
    setattr(TPGroup, op, _recorded)


def expert_counts(params):
    # the expert dim of every expert-stack leaf of a tree
    return sorted({v.shape[0] for layer in params["layers"].values()
                   for proj in layer["mlp"].get("experts", {}).values() for v in proj.values()})


out = {"forward": {}, "engine": {}, "raises": {}}
i32 = dict(dtype=torch.int32)
PAGE, MAXP, BUCKET = 4, 8, 16

group = TPGroup()
for name, f in spec.get("forward", {}).items():
    full_cfg = model_config(f["model"])
    cfg = rank_config(full_cfg, world)
    os.environ.update(f.get("env", {}))
    if f.get("hf"):
        # a checkpoint's HF tensors through the loader, the rank's shard as it reads them
        with np.load(f["hf"]) as state:
            items = [(k, state[k]) for k in state.files]
        params = map_hf_params(items, full_cfg, dtype=torch.float32, quant_method=f["method"],
                               shard=(rank, world))
    else:
        params = shard_params(load(f["params"]), rank, world, cfg=full_cfg)
    for key in f.get("env", {}):
        os.environ.pop(key)
    params = params_to_torch(params, "cpu", torch.float32)
    if f.get("auto_int8"):
        params = quantize_int8_params(params, tp=group)
    routed.clear(), moe_collectives.clear()
    rope = L.build_rope(cfg)
    n = len(f["tokens"])
    tok = torch.zeros(BUCKET, **i32); tok[:n] = torch.tensor(f["tokens"])
    pos = torch.zeros(BUCKET, **i32); pos[:n] = torch.arange(n)
    slots = torch.full((BUCKET,), -1, **i32); slots[:n] = torch.arange(n)
    pages = (n + PAGE - 1) // PAGE
    pt = torch.full((MAXP,), -1, **i32); pt[:pages] = torch.arange(pages)
    meta = PrefillMeta(positions=pos, slot_mapping=slots, page_table=pt,
                       cache_len=torch.tensor(0, **i32), q_len=torch.tensor(n, **i32))
    cache = (new_latent_cache(cfg.num_layers, 32, PAGE, cfg.mla.latent_dim, torch.float32)
             if cfg.mla.enabled else
             new_kv_cache(cfg.num_layers, 32, PAGE, cfg.num_kv_heads, cfg.dim_head, torch.float32))
    p2 = torch.full((2, MAXP), -1, **i32); p2[0, : n // PAGE + 1] = torch.arange(n // PAGE + 1)
    dmeta = DecodeMeta(positions=torch.tensor([n, 0], **i32),
                       slot_mapping=torch.tensor([n, -1], **i32), page_tables=p2,
                       context_lens=torch.tensor([n + 1, 0], **i32))
    with torch.no_grad():
        collectives.clear()
        logits, cache = L.forward_prefill(params, cfg, rope, tok, meta, cache, tp=group)
        prefill_collectives = list(collectives)
        dtok = torch.tensor([f["decode_token"], 0], **i32)
        dlogits, cache = L.forward_decode(params, cfg, rope, dtok, dmeta, cache, tp=group)
    out["forward"][name] = dict(prefill=logits.tolist(), decode=dlogits[0].tolist(),
                                pool=list((cache.latent if cfg.mla.enabled else cache.k)[0].shape),
                                experts=list(routed), moe_collectives=list(moe_collectives),
                                expert_counts=expert_counts(params),
                                collectives=prefill_collectives,
                                leaves={k: [str(v.dtype), list(v.shape)] for k, v in flat(params)})


def engine_config(case, tp):
    return EngineConfig(max_model_len=case["max_model_len"], cache=CacheConfig(**case["cache"]),
                        scheduler=SchedulerConfig(**case["sched"]),
                        parallel=ParallelConfig(tp=tp))


def cancel_one(gen, prompt):
    # a streamed request cancelled after its second token
    task = SearchTask(prompt, GeneratorArg(max_length=40, ignore_eos=True), stream=True)
    gen.scheduler.submit(task)
    seen = 0
    while True:
        flag, payload = task.res_queue.get(timeout=60)
        if flag == StreamResultType.Incremental:
            seen += 1
            if seen == 2:
                task.cancel()
        elif flag == StreamResultType.Final:
            return str(task.task_id)


llm = None
decide_num_pages = ModelExecutor._decide_num_pages
for name, case in spec.get("engine", {}).items():
    os.environ.pop("ZT_WINDOW_KV", None)
    os.environ.pop("ZT_FUSED_KV", None)
    os.environ.update(case.get("env", {}))
    # a pool budget of the rank's own, as where the ranks' free memory differs
    ModelExecutor._decide_num_pages = (
        (lambda self, n=case["budgets"][rank]: n) if case.get("budgets") else decide_num_pages)
    finished.clear()
    window_steps[0] = 0
    # the weights as a tree, or a checkpoint directory each rank reads its shard of
    weights = (dict(model_path=case["model_path"]) if case.get("model_path")
               else dict(params=load(case["params"])))
    llm = LLM(model_config=model_config(case["model"]), engine_config=engine_config(case, world),
              device="cpu", **weights)
    ex = llm.executor
    routed.clear()
    gen = DynamicBatchGenerator(llm).start()
    latent = ex.cache.is_latent
    rec = dict(pool=list((ex.cache.latent if latent else ex.cache.k)[0].shape),
               packed=None if latent else ex.cache.packed,
               scales=list(ex.cache.k_scale[0].shape) if ex.cache.quantized else None,
               kv_bytes=ex._kv_bytes_per_token(), num_pages=ex.num_pages,
               window_kv=ex.window_kv, fused_kv=ex.fused_kv,
               expert_counts=expert_counts(ex.params))
    if rank == 0:
        rec["greedy"] = [r.outputs[0].token_ids for r in gen.batch_generate(
            case["prompts"], GeneratorArg(**case["arg"]), timeout=100)]
        if case.get("extras"):
            rec["sampled"] = gen.generate(case["prompts"][0], GeneratorArg(
                max_length=6, temperature=0.8, top_p=0.9, seed=7), timeout=100).outputs[0].token_ids
            with SessionGenerator(gen) as sess:
                sess.generate(case["prompts"][1][:6], GeneratorArg(max_length=3))
                sess.generate(case["prompts"][2][:4], GeneratorArg(max_length=3))
            rec["cancelled"] = cancel_one(gen, case["prompts"][2])
        gen.stop()
    else:
        gen.scheduler._thread.join(timeout=100)
        assert not gen.scheduler._thread.is_alive(), "rank 1's scheduler did not stop"
        assert gen.scheduler.error is None, gen.scheduler.error
    rec.update(finished=dict(finished), sessions=len(gen.scheduler.sessions),
               preemptions=gen.scheduler.num_preemptions, window_steps=window_steps[0],
               routings=len(routed),
               experts=hashlib.sha256(json.dumps(routed).encode()).hexdigest())
    out["engine"][name] = rec
os.environ.pop("ZT_WINDOW_KV", None)
os.environ.pop("ZT_FUSED_KV", None)

if spec.get("raises"):
    def raises(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            return f"{type(e).__name__}: {e}"
        return None

    case = spec["raises"]
    out["raises"]["world_not_tp"] = raises(lambda: LLM(
        model_config=ModelConfig(**case["model"]), params=load(case["params"]),
        engine_config=EngineConfig(parallel=ParallelConfig(tp=2 * world)), device="cpu"))
    out["raises"]["calc_logits"] = raises(lambda: llm.calc_logits([3, 4, 5]))
    out["raises"]["calc_loss"] = raises(lambda: llm.calc_loss([3, 4, 5]))
    out["raises"]["calc_act_scales"] = raises(lambda: llm.calc_act_scales([[3, 4, 5]]))

json.dump(out, open(out_path, "w"))
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank} DONE", flush=True)
"""


class Ranks:
    """``world`` rank processes over one spec, started now; ``result()``
    waits for them (each with a timeout) and returns every rank's output."""

    def __init__(self, spec: dict, world: int, tmp: Path):
        self.tmp = tmp
        (tmp / "spec.json").write_text(json.dumps(spec))
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX", "XLA", "ZT_")) and k not in LAUNCH_VARS}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.outs = [tmp / f"rank{r}.json" for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, str(tmp / "spec.json"), str(r), str(world), str(port),
             str(self.outs[r])], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._result = None

    def result(self):
        if self._result is None:
            deadline = time.monotonic() + TIMEOUT
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
            self._result = [json.loads(o.read_text()) for o in self.outs]
        return self._result


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

# forward: tests/test_tensor_parallel.py's shapes at head_dim 64 (both
# packages' packed head-major pool), 8 query / 4 KV heads, so TP=4 holds one
# KV head a rank
FWD_MODEL = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=8, dim_head=64,
                 num_kv_heads=4, dim_ff=128, vocab_size=128, dtype="float32")
FORWARD = {
    "dense": (dict(), False),
    # biases on every linear: q/k/v and gate/up sharded, o_proj and down_proj
    # replicated and added once after the reduce
    "qwen2_biases": (dict(model_type="qwen2", attn_bias=True), True),
    # the tied, vocab-sharded head, scale_emb after the embedding's reduce
    "minicpm": (dict(model_type="cpm_dragonfly", scale_emb=12.0, scale_depth=1.4,
                     dim_model_base=16, tie_lm_head=True), False),
}
FWD_TOKENS = [int(t) for t in np.random.RandomState(0).randint(0, 128, size=11)]
DECODE_TOKEN = 17
PAGE, MAXP, BUCKET = 4, 8, 16

VOCAB, EOS = 64, 1
ENG_MODEL = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=64,
                 num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")
ENG_SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
                 eos_id=EOS)
_rng = np.random.RandomState(5)
PROMPTS = [[int(t) for t in _rng.randint(2, VOCAB, size=n)] for n in (5, 13, 21)]
_rng = np.random.RandomState(21)
PRESSURE_PROMPTS = [[int(t) for t in _rng.randint(2, VOCAB, size=7)] for _ in range(2)]
# 8 pages of 4 tokens and optimistic admission: two (7-token prompt, 20 new
# tokens) requests need 54, so the newer one is preempted
PRESSURE_SCHED = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32), eos_id=EOS,
                      ignore_eos=True, admission_reserve=0.2, session_ttl=0.0)

ENGINE = {
    "packed": dict(extras=True),
    "slot_major": dict(model=dict(dim_head=16)),
    "int8": dict(cache=dict(kv_dtype="int8")),
    "window": dict(env={"ZT_WINDOW_KV": "1"}),
    "swap": dict(pressure="swap"),
    "recompute": dict(pressure="recompute"),
    # no num_pages: each rank's pool budget is its own (rank 0's the larger),
    # and the ranks agree on the smallest, the 8 pages that preempt
    "rank_budgets": dict(pressure="swap", budgets=[16, 8]),
}


def _engine_case(name, params_path):
    spec = ENGINE[name]
    case = dict(model=dict(ENG_MODEL, **spec.get("model", {})), params=params_path,
                env=spec.get("env", {}), extras=spec.get("extras", False), max_model_len=64)
    if "budgets" in spec:
        case.update(budgets=spec["budgets"], cache=dict(page_size=4),
                    sched=dict(PRESSURE_SCHED, preempt_mode=spec["pressure"]),
                    prompts=PRESSURE_PROMPTS, arg=dict(max_length=20))
    elif "pressure" in spec:
        case.update(cache=dict(page_size=4, num_pages=8),
                    sched=dict(PRESSURE_SCHED, preempt_mode=spec["pressure"]),
                    prompts=PRESSURE_PROMPTS, arg=dict(max_length=20))
    else:
        case.update(cache=dict(dict(page_size=4, num_pages=64), **spec.get("cache", {})),
                    sched=ENG_SCHED, prompts=PROMPTS, arg=dict(max_length=8))
    return case


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The rank processes of every case, started together: a pair and a
    quartet for the forward at TP=2 and TP=4, a pair for the engine cases and
    the raises, and the server's two ranks."""
    tmp = tmp_path_factory.mktemp("tp")
    fwd = {}
    for name, (model, biases) in FORWARD.items():
        model = dict(FWD_MODEL, **model)
        path = _save(_params(JModelConfig(**model), biases=biases), tmp / f"fwd_{name}.npz")
        fwd[name] = dict(model=model, params=path, tokens=FWD_TOKENS, decode_token=DECODE_TOKEN)
    eng, saved = {}, {}
    for name in ENGINE:
        model = dict(ENG_MODEL, **ENGINE[name].get("model", {}))
        key = json.dumps(model, sort_keys=True)
        if key not in saved:
            saved[key] = _save(_params(JModelConfig(**model)), tmp / f"eng_{len(saved)}.npz")
        eng[name] = _engine_case(name, saved[key])
    for sub in ("tp2", "tp4", "engine"):
        (tmp / sub).mkdir()
    running = {
        "server": TPServer(tmp / "server"),
        "tp2": Ranks(dict(forward=fwd), 2, tmp / "tp2"),
        "tp4": Ranks(dict(forward=fwd), 4, tmp / "tp4"),
        "engine": Ranks(dict(engine=eng, raises=fwd["dense"]), 2, tmp / "engine"),
        "params": {name: f["params"] for name, f in fwd.items()},
        "cases": eng,
    }
    yield running
    running["server"].stop()


def _load(path):
    return {k: v for k, v in np.load(path).items()}


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parts, leaf = key.split(".")
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

def _spec_dim(spec):
    dims = [i for i, axis in enumerate(spec) if axis == TP_AXIS]
    assert len(dims) <= 1
    return dims[0] if dims else None


RULE_TREES = {
    "llama": dict(),
    "qwen2_biases": dict(model_type="qwen2", attn_bias=True),
    "minicpm": dict(model_type="cpm_dragonfly", tie_lm_head=True, scale_emb=12.0),
    "qwen3_qk_norm": dict(model_type="qwen3", qk_norm=True),
    "moe": dict(model_type="qwen2_moe", moe=dict(num_experts=4, top_k=2, intermediate_size=64,
                                                  shared_expert_intermediate_size=64,
                                                  shared_expert_gate=True)),
    "mla": dict(model_type="deepseek_v2", num_heads=4, num_kv_heads=4, dim_head=8,
                mla=dict(q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8,
                         qk_rope_head_dim=4, v_head_dim=8),
                moe=dict(num_experts=4, top_k=2, intermediate_size=32, first_k_dense_replace=1,
                         shared_expert_intermediate_size=32)),
    "stacked": dict(),
}
# leaves no random tree holds: int4 linears and expert stacks (matching no
# rule but the expert ones), fused projections
EXTRA_PATHS = [(p, n) for p in (
    "layers.0.attn.q_proj.w_p", "layers.0.attn.q_proj.scales", "layers.0.mlp.down_proj.zeros",
    "layers.1.mlp.experts.gate_proj.w_p", "layers.1.mlp.experts.down_proj.scales",
    "layers.1.mlp.experts.up_proj.zeros", "layers.1.mlp.experts.gate_proj.g_idx",
    "layers.1.mlp.experts.down_proj.perm", "layers.0.attn.qkv_proj.w", "layers.0.attn.qkv_proj.b",
    "layers.0.mlp.gate_up_proj.w", "layers.0.mlp.gate_up_proj.b",
    "layers.1.mlp.experts.gate_up_proj.w",
    "layers.1.mlp.shared_expert_gate.gate_proj.w", "lm_head.w", "layer_stack.mlp.down_proj.w",
) for n in (1, 2, 3)]


@pytest.mark.parametrize("tree", list(RULE_TREES))
def test_rule_table_matches_param_pspec(tree):
    kw = dict(dict(num_layers=2, dim_model=32, num_heads=4, dim_head=8, num_kv_heads=2, dim_ff=64,
                   vocab_size=64, dtype="float32"), **RULE_TREES[tree])
    mla, moe = kw.pop("mla", None), kw.pop("moe", None)
    jcfg = JModelConfig(**kw, **({"mla": JMLAConfig(**mla)} if mla else {}),
                        **({"moe": JMoEConfig(**moe)} if moe else {}))
    # the leaves' shapes only: the tree traced, nothing drawn
    params = jax.eval_shape(
        lambda: JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    if tree == "stacked":
        params = jax.eval_shape(lambda p: JS.stack_params(jcfg, p), params)
    leaves = [(path, len(x.shape)) for path, x in _flat(params)]
    if tree == "llama":
        leaves += EXTRA_PATHS
    assert len(leaves) > 8
    sharded = 0
    for path, ndim in leaves:
        want = _spec_dim(param_pspec(path, ndim))
        assert param_shard_dim(path, ndim) == want, path
        sharded += want is not None
    assert sharded > 0
    if tree == "stacked":
        assert any(p.startswith("layer_stack.") and param_shard_dim(p, n) == 2
                   for p, n in leaves), "no stacked leaf took the shifted column dim"


def test_shard_params_slices_by_the_rule_table():
    """Each rank's leaf is its 1/tp slice of the sharded dim, contiguous, and
    the ranks' slices put back together give the full leaf; ``LLM`` tells a
    shard from the full tree by its embedding's rows."""
    model = dict(FWD_MODEL, model_type="qwen2", attn_bias=True)
    params = _params(JModelConfig(**model), biases=True)
    shards = [shard_params(params, r, 4, ModelConfig(**model)) for r in range(4)]
    assert is_shard(shards[2], ModelConfig(**model), 4)
    assert not is_shard(params, ModelConfig(**model), 4)
    for path, full in _flat(params):
        parts = [dict(_flat(s))[path] for s in shards]
        dim = param_shard_dim(path, full.ndim)
        assert all(p.is_contiguous() for p in parts), path
        if dim is None:
            assert all(np.array_equal(p.numpy(), full) for p in parts), path
        else:
            assert parts[0].shape[dim] * 4 == full.shape[dim], path
            np.testing.assert_array_equal(torch.cat(parts, dim).numpy(), full, err_msg=path)


def test_init_params_shard_keeps_the_full_draw_slice():
    """``init_params(..., shard=(rank, tp))`` draws the same tensors and keeps
    the rank's slices: the shard of the full draw, leaf for leaf."""
    cfg = ModelConfig(**FWD_MODEL)
    full = shard_params(TL.init_params(cfg, 3, "cpu"), 1, 2, cfg)
    part = TL.init_params(cfg, 3, "cpu", shard=(1, 2))
    assert is_shard(part, cfg, 2)
    a, b = dict(_flat(full)), dict(_flat(part))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_loader_slices_each_tensor_as_it_reads_it():
    """``map_hf_params(..., shard=(rank, tp))`` on HF-named tensors ([out, in],
    q/k/v biases) gives the shard of the full tree it builds without one."""
    from zhilight_tpu_torch.utils.hf_loader import map_hf_params

    cfg = ModelConfig(**dict(FWD_MODEL, model_type="qwen2", attn_bias=True))
    g = torch.Generator().manual_seed(0)
    d, f, V = cfg.dim_model, cfg.dim_ff, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.dim_head, cfg.num_kv_heads * cfg.dim_head
    state = {"model.embed_tokens.weight": torch.randn(V, d, generator=g),
             "model.norm.weight": torch.randn(d, generator=g),
             "lm_head.weight": torch.randn(V, d, generator=g)}
    pre = "model.layers.0."
    for name, shape in (("self_attn.q_proj.weight", (hq, d)), ("self_attn.q_proj.bias", (hq,)),
                        ("self_attn.k_proj.weight", (hkv, d)), ("self_attn.k_proj.bias", (hkv,)),
                        ("self_attn.v_proj.weight", (hkv, d)), ("self_attn.v_proj.bias", (hkv,)),
                        ("self_attn.o_proj.weight", (d, hq)), ("mlp.gate_proj.weight", (f, d)),
                        ("mlp.up_proj.weight", (f, d)), ("mlp.down_proj.weight", (d, f)),
                        ("input_layernorm.weight", (d,)), ("post_attention_layernorm.weight", (d,))):
        state[pre + name] = torch.randn(*shape, generator=g)
    full = map_hf_params(state.items(), cfg, dtype=torch.float32)
    for rank in range(2):
        want = dict(_flat(shard_params(full, rank, 2, cfg)))
        got = dict(_flat(map_hf_params(state.items(), cfg, dtype=torch.float32,
                                       shard=(rank, 2))))
        assert want.keys() == got.keys()
        assert all(torch.equal(want[k], got[k]) and got[k].is_contiguous() for k in want)


def test_reference_all_reduces_row_parallel_products_in_fp32():
    """The reference's row-parallel ``linear`` on a tp mesh, compiled: the
    dot's fp32 result is all-reduced and converted to bf16 after the sum, so
    the port's ``_reduce_linear`` reduces in fp32 too (not bf16 partials)."""
    from zhilight_tpu.ops.linear import linear as j_linear

    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    x = jax.device_put(jnp.ones((8, 64), jnp.bfloat16), NamedSharding(mesh, P(None, TP_AXIS)))
    w = jax.device_put(jnp.ones((64, 32), jnp.bfloat16), NamedSharding(mesh, P(TP_AXIS, None)))
    fn = jax.jit(lambda p, x: j_linear(p, x), out_shardings=NamedSharding(mesh, P()))
    hlo = fn.lower({"w": w}, x).compile().as_text()
    reduces = [line for line in hlo.splitlines() if "all-reduce(" in line]
    assert reduces and all("= f32[" in line for line in reduces), reduces


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _jax_forward(jcfg, params, tp):
    """Prefill logits [V] of FWD_TOKENS and one decode step's [V] (token
    DECODE_TOKEN), on a tp mesh where tp > 1."""
    rope = JL.build_rope(jcfg)
    n = len(FWD_TOKENS)
    tok = np.zeros(BUCKET, np.int32)
    tok[:n] = FWD_TOKENS
    pos = np.zeros(BUCKET, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(BUCKET, -1, np.int32)
    slots[:n] = np.arange(n)
    pt = np.full(MAXP, -1, np.int32)
    pt[: (n + PAGE - 1) // PAGE] = np.arange((n + PAGE - 1) // PAGE)
    meta = JPrefillMeta(positions=jnp.asarray(pos), slot_mapping=jnp.asarray(slots),
                        page_table=jnp.asarray(pt), cache_len=jnp.int32(0), q_len=jnp.int32(n))
    p2 = np.full((2, MAXP), -1, np.int32)
    p2[0, : n // PAGE + 1] = np.arange(n // PAGE + 1)
    dmeta = JDecodeMeta(positions=jnp.asarray([n, 0], jnp.int32),
                        slot_mapping=jnp.asarray([n, -1], jnp.int32),
                        page_tables=jnp.asarray(p2),
                        context_lens=jnp.asarray([n + 1, 0], jnp.int32))
    mesh = make_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])
    # the engine's placement (zhilight_tpu/engine/engine.py:262-306): the
    # packed head-major pool on its head dim, a latent pool replicated
    if jcfg.mla.enabled:
        cache = j_new_latent_cache(jcfg.num_layers, 32, PAGE, jcfg.mla.latent_dim, jnp.float32,
                                   sharding=NamedSharding(mesh, P()))
    else:
        cache = j_new_kv_cache(jcfg.num_layers, 32, PAGE, jcfg.num_kv_heads, jcfg.dim_head,
                               jnp.float32, kv_sharding=NamedSharding(mesh, P(TP_AXIS, None, None)))
    with mesh:
        sharded = j_shard_params(params, mesh)
        pre = jax.jit(lambda pr, tk, mt, ca: JL.forward_prefill(pr, jcfg, rope, tk, mt, ca))
        dec = jax.jit(lambda pr, tk, mt, ca: JL.forward_decode(pr, jcfg, rope, tk, mt, ca))
        logits, cache = pre(sharded, jnp.asarray(tok), meta, cache)
        dlogits, _ = dec(sharded, jnp.asarray([DECODE_TOKEN, 0], jnp.int32), dmeta, cache)
    return np.asarray(logits), np.asarray(dlogits[0])


def _port_forward(cfg, params):
    """The single-process port's prefill and decode logits, as the ranks run them."""
    i32 = dict(dtype=torch.int32)
    rope = TL.build_rope(cfg)
    n = len(FWD_TOKENS)
    tok = torch.zeros(BUCKET, **i32)
    tok[:n] = torch.tensor(FWD_TOKENS)
    pos = torch.zeros(BUCKET, **i32)
    pos[:n] = torch.arange(n)
    slots = torch.full((BUCKET,), -1, **i32)
    slots[:n] = torch.arange(n)
    pt = torch.full((MAXP,), -1, **i32)
    pt[: (n + PAGE - 1) // PAGE] = torch.arange((n + PAGE - 1) // PAGE)
    meta = PrefillMeta(positions=pos, slot_mapping=slots, page_table=pt,
                       cache_len=torch.tensor(0, **i32), q_len=torch.tensor(n, **i32))
    cache = (new_latent_cache(cfg.num_layers, 32, PAGE, cfg.mla.latent_dim, torch.float32)
             if cfg.mla.enabled else
             new_kv_cache(cfg.num_layers, 32, PAGE, cfg.num_kv_heads, cfg.dim_head, torch.float32))
    p2 = torch.full((2, MAXP), -1, **i32)
    p2[0, : n // PAGE + 1] = torch.arange(n // PAGE + 1)
    dmeta = DecodeMeta(positions=torch.tensor([n, 0], **i32),
                       slot_mapping=torch.tensor([n, -1], **i32), page_tables=p2,
                       context_lens=torch.tensor([n + 1, 0], **i32))
    with torch.no_grad():
        logits, cache = TL.forward_prefill(params, cfg, rope, tok, meta, cache)
        dlogits, _ = TL.forward_decode(params, cfg, rope, torch.tensor([DECODE_TOKEN, 0], **i32),
                                       dmeta, cache)
    return logits.numpy(), dlogits[0].numpy()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_matches_single_process_and_jax_mesh(ranks, name, tp):
    model = dict(FWD_MODEL, **FORWARD[name][0])
    params = _tree(_load(ranks["params"][name]))
    want_pre, want_dec = _jax_forward(JModelConfig(**model), params, tp)
    one_pre, one_dec = _port_forward(ModelConfig(**model),
                                     params_to_torch(params, "cpu", torch.float32))
    outs = [r["forward"][name] for r in ranks[f"tp{tp}"].result()]
    # the pool holds the rank's KV heads: [Hkv / tp, N, 2D]
    assert outs[0]["pool"] == [model["num_kv_heads"] // tp, 32 * PAGE, 2 * model["dim_head"]]
    for out in outs:
        # every rank ends with the same gathered logits
        assert out["prefill"] == outs[0]["prefill"] and out["decode"] == outs[0]["decode"]
    got_pre, got_dec = np.asarray(outs[0]["prefill"]), np.asarray(outs[0]["decode"])
    assert got_pre.shape == (model["vocab_size"],)
    for got, one, want in ((got_pre, one_pre, want_pre), (got_dec, one_dec, want_dec)):
        np.testing.assert_allclose(got, one, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _jax_tokens(case, monkeypatch, jcfg=None):
    """The JAX engine's greedy tokens at ParallelConfig(tp=2), with room for
    every request (its own ZT_WINDOW_KV=1 with interpret kernels for the
    window case); ``jcfg`` in place of the case's model fields."""
    model = case["model"]
    params = _tree(_load(case["params"]))
    cache, sched = dict(case["cache"]), dict(case["sched"])
    if sched.get("admission_reserve", 1.0) < 1.0:
        cache["num_pages"], sched["admission_reserve"] = 64, 1.0
        sched.pop("preempt_mode")
    with monkeypatch.context() as m:
        for key, value in case["env"].items():
            m.setenv(key, value)
        if case["env"]:
            m.setenv("ZT_PALLAS_INTERPRET", "1")
        jllm = JLLM(model_config=jcfg or JModelConfig(**model), params=params,
                    engine_config=JEngineConfig(max_model_len=case["max_model_len"],
                                                cache=JCacheConfig(**cache),
                                                scheduler=JSchedulerConfig(**sched),
                                                parallel=JParallelConfig(tp=2)))
        with JGenerator(jllm) as gen:
            res = gen.batch_generate(case["prompts"], JGeneratorArg(**case["arg"]), timeout=300)
    return [r.outputs[0].token_ids for r in res], jllm


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_tokens_match_jax_tp2(ranks, name, monkeypatch):
    case = ranks["cases"][name]
    want, jllm = _jax_tokens(case, monkeypatch)
    r0, r1 = (r["engine"][name] for r in ranks["engine"].result())
    assert r0["greedy"] == want
    assert all(len(t) >= 1 for t in want)
    # both ranks finished every request with the same tokens
    assert r0["finished"] and r0["finished"] == r1["finished"]
    model, kv = case["model"], case["model"]["num_kv_heads"] // 2
    if r0["packed"]:
        assert r0["pool"] == [kv, r0["num_pages"] * 4, 2 * model["dim_head"]]
    else:
        assert r0["pool"] == [1, r0["num_pages"] * 4, kv, model["dim_head"]]
    assert jllm.executor.cache.packed == r0["packed"]
    if case["cache"].get("kv_dtype") == "int8":
        assert r0["scales"] == [kv, r0["num_pages"] * 4 + 1]
        # the reference's bytes a token over tp, so the pool sizes alike
        assert r0["kv_bytes"] == jllm.executor._kv_bytes_per_token()
    if name == "window":
        assert r0["window_kv"] and r0["window_steps"] > 0 and r1["window_steps"] > 0
    if name in ("swap", "recompute", "rank_budgets"):
        assert r0["preemptions"] >= 1 and r0["preemptions"] == r1["preemptions"]
    if name == "rank_budgets":
        # one page count for the group, whatever each rank's budget
        assert r0["num_pages"] == r1["num_pages"] == min(case["budgets"])


def test_ranks_agree_on_sampled_session_and_cancel(ranks):
    """A seeded sampled request, a two-turn session and a request cancelled
    after its second token, on rank 0; rank 1 replays each, closes the
    session and stops on rank 0's shutdown sentinel."""
    r0, r1 = (r["engine"]["packed"] for r in ranks["engine"].result())
    assert len(r0["sampled"]) == 6
    assert r0["finished"] == r1["finished"]
    cancelled = r0["finished"][r0["cancelled"]]
    assert 2 <= len(cancelled) < 40
    assert r0["sessions"] == r1["sessions"] == 0


def test_pool_bytes_per_token_divide_by_tp(ranks):
    """A rank's pool takes the single-process pool's bytes a token over tp."""
    case = ranks["cases"]["packed"]
    one = LLM(model_config=ModelConfig(**case["model"]), params=_tree(_load(case["params"])),
              device="cpu", engine_config=EngineConfig(
                  max_model_len=64, cache=CacheConfig(**case["cache"]),
                  scheduler=SchedulerConfig(**case["sched"])))
    r0 = ranks["engine"].result()[0]["engine"]["packed"]
    assert r0["kv_bytes"] * 2 == one.executor._kv_bytes_per_token()


# ---------------------------------------------------------------------------
# the raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,change", [
    ("vocab_size", dict(vocab_size=127)),
    ("num_kv_heads", dict(num_kv_heads=1, num_heads=3)),
    ("dim_ff", dict(dim_ff=129)),
])
def test_sizes_tp_does_not_divide_raise(what, change, monkeypatch):
    cfg = ModelConfig(**dict(FWD_MODEL, **change))
    with pytest.raises(ValueError, match=what):
        check_tp(cfg, 2)
    # before any process group is looked for
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=what):
        LLM(model_config=cfg, params={}, device="cpu",
            engine_config=EngineConfig(parallel=ParallelConfig(tp=2)))
    if what != "num_kv_heads":
        # the leaf itself: no padding
        params = _params(JModelConfig(**dict(FWD_MODEL, **change)))
        with pytest.raises(ValueError, match="does not divide by tp=2"):
            shard_params(params, 0, 2, cfg)


class _SoloRank:
    """Rank 0 of a two-rank group whose other rank holds the same values:
    a sum is the value, a gather repeats it (enough to build a rank's LLM
    in this process, beside a local control plane)."""
    rank, world = 0, 2

    def all_reduce(self, x, op=None):
        return x

    def all_gather(self, x, dim):
        return torch.cat([x] * self.world, dim=dim)


@pytest.mark.parametrize("kind", ["gptq", "int8", "quantized_leaf"])
def test_what_tp_does_not_serve_yet_raises(kind, monkeypatch):
    """Quantized linears under tp > 1, refused until they were ported, now
    build: a GPTQ and an AUTO_INT8 ``LLM`` at tp=2 keep rank 0's shard (its
    half of q_proj's columns and of o_proj's rows), and ``shard_params``
    slices a bare int4 leaf of a column-parallel projection."""
    import zhilight_tpu_torch.llm as t_llm
    from zhilight_tpu_torch.ops.quant import pack_int4

    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    model, quant = dict(FWD_MODEL), QuantConfig()
    if kind == "quantized_leaf":
        quantized = {"w_p": np.zeros((4, 4), np.uint8)}
        got = shard_params({"layers": {"0": {"attn": {"q_proj": quantized}}}}, 0, 2,
                           ModelConfig(**model))
        assert tuple(got["layers"]["0"]["attn"]["q_proj"]["w_p"].shape) == (4, 2)
        return
    import zhilight_tpu_torch.engine.engine as t_engine
    from zhilight_tpu_torch.parallel.control_plane import LocalPlane

    monkeypatch.setattr(t_llm, "join", lambda tp, device: _SoloRank())
    monkeypatch.setattr(t_engine, "DistPlane", LocalPlane)
    params = _params(JModelConfig(**model))
    if kind == "gptq":
        quant = QuantConfig(quant_type=QuantType.GPTQ)
        rng = np.random.RandomState(0)
        for layer in params["layers"].values():
            for group in (layer["attn"], layer["mlp"]):
                for name, p in list(group.items()):
                    K, N = p["w"].shape
                    nib = torch.from_numpy(rng.randint(0, 16, size=(K, N)).astype(np.int8))
                    group[name] = {"w_p": (pack_int4(nib) if K % 256 == 0 else nib).numpy(),
                                   "scales": np.full((K // 32, N), 0.01, np.float32),
                                   "zeros": np.full((K // 32, N), 8.0, np.float32)}
    else:
        quant = QuantConfig(quant_type=QuantType.AUTO_INT8)
        from zhilight_tpu_torch.utils.quant_convert import quantize_int8_params

        params = quantize_int8_params(params_to_torch(params, "cpu", torch.float32))
    llm = LLM(model_config=ModelConfig(**model), params=params, quant_config=quant, device="cpu",
              engine_config=EngineConfig(max_model_len=64,
                                         cache=CacheConfig(page_size=4, num_pages=16),
                                         parallel=ParallelConfig(tp=2)))
    attn = llm.executor.params["layers"]["0"]["attn"]
    q, o = ("w_p", "w_p") if kind == "gptq" else ("w_q", "w_q")
    assert attn["q_proj"][q].shape[-1] == model["num_heads"] * model["dim_head"] // 2
    rows = attn["o_proj"][o].shape[0] * (2 if attn["o_proj"][o].dtype == torch.uint8 else 1)
    assert rows == model["num_heads"] * model["dim_head"] // 2


def test_tp_without_a_process_group_raises(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        LLM(model_config=ModelConfig(**FWD_MODEL), params={}, device="cpu",
            engine_config=EngineConfig(parallel=ParallelConfig(tp=2)))
    with pytest.raises(NotImplementedError, match="load_with_smooth_quant"):
        LLM.load_with_smooth_quant("unused", [[3, 4]], engine_config=EngineConfig(
            parallel=ParallelConfig(tp=2)))


def test_rank_device_defaults_to_local_rank(monkeypatch):
    """A rank's device: ``cuda:LOCAL_RANK`` when none is given or when it is
    ``"cuda"`` with no index (which ``torch.cuda.set_device`` refuses);
    an indexed or a CPU device as given."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert local_device(None) == torch.device("cuda", 1)
    assert local_device("cuda") == torch.device("cuda", 1)
    assert local_device(torch.device("cuda")) == torch.device("cuda", 1)
    assert local_device("cuda:0") == torch.device("cuda", 0)
    assert local_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("what", ["world_not_tp", "calc_logits", "calc_loss", "calc_act_scales"])
def test_rank_raises(ranks, what):
    """On the ranks: a group whose world is not tp; scoring and calibration
    of a tensor-parallel LLM (they run outside the scheduler loop)."""
    for r in ranks["engine"].result():
        msg = r["raises"][what]
        assert msg is not None, what
        if what == "world_not_tp":
            assert msg.startswith("ValueError") and "the process group has 2 ranks" in msg
        else:
            assert msg.startswith("NotImplementedError") and "tensor parallelism" in msg


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

SERVER_MODEL = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                    num_attention_heads=2, num_key_value_heads=2)


def _checkpoint(path: Path) -> str:
    """tools/make_tiny_model.py's tokenizer beside a llama of head_dim 64
    written as a torch ``.bin``, its vocab the tokenizer's rounded up to an
    even count (tp=2 divides it; the reference's mesh would refuse an odd
    one), weights from a seed."""
    spec = importlib.util.spec_from_file_location("make_tiny_model",
                                                  REPO / "tools" / "make_tiny_model.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    path.mkdir()
    vocab = maker.write_tokenizer(str(path))
    vocab += vocab % 2
    d, f, L, H = (SERVER_MODEL[k] for k in ("hidden_size", "intermediate_size",
                                             "num_hidden_layers", "num_attention_heads"))
    cfg = dict(SERVER_MODEL, architectures=["LlamaForCausalLM"], model_type="llama",
               vocab_size=vocab, max_position_embeddings=2048, rms_norm_eps=1e-6,
               bos_token_id=0, eos_token_id=1, tie_word_embeddings=False, torch_dtype="float32")
    (path / "config.json").write_text(json.dumps(cfg))
    g = torch.Generator().manual_seed(0)
    w = lambda *s: torch.randn(*s, generator=g) / s[-1] ** 0.5
    state = {"model.embed_tokens.weight": w(vocab, d), "model.norm.weight": torch.ones(d),
             "lm_head.weight": w(vocab, d)}
    for i in range(L):
        pre = f"model.layers.{i}."
        state.update({pre + "input_layernorm.weight": torch.ones(d),
                      pre + "post_attention_layernorm.weight": torch.ones(d),
                      pre + "mlp.gate_proj.weight": w(f, d), pre + "mlp.up_proj.weight": w(f, d),
                      pre + "mlp.down_proj.weight": w(d, f)})
        for m in "qkvo":
            state[pre + f"self_attn.{m}_proj.weight"] = w(d, d)
    torch.save(state, path / "pytorch_model.bin")
    return str(path)


SERVER_FLAGS = ["--device", "cpu", "--max-model-len", "256", "--dyn-max-batch-size", "4",
                "--chunk-size", "64", "--max-total-token", "1024"]
COMPLETION = {"prompt": "hello world", "max_tokens": 8, "temperature": 0}


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


class TPServer:
    """``api_server --tensor-parallel 2`` as two processes with torchrun's
    variables over :func:`_checkpoint`, started now (where aiohttp and
    transformers import), each logging to a file of its own."""

    def __init__(self, tmp: Path):
        self.procs, self.logs = [], []
        self.missing = [m for m in ("aiohttp", "pydantic", "transformers")
                        if importlib.util.find_spec(m) is None]
        if self.missing:
            return
        self.ckpt = _checkpoint(tmp)
        self.port, master = _free_port(), _free_port()
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "ZT_"))}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
        for r in range(2):
            self.logs.append(tmp / f"rank{r}.log")
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "zhilight_tpu_torch.server.openai.api_server",
                     "--model-path", self.ckpt, "--host", "127.0.0.1", "--port", str(self.port),
                     "--tensor-parallel", "2", *SERVER_FLAGS],
                    cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT))

    def log(self, r: int) -> str:
        return self.logs[r].read_text()[-4000:]

    def stop(self):
        """Rank 0 stops (SIGTERM); its shutdown sentinel stops rank 1.
        Returns the exit codes."""
        if not self.procs:
            return []
        self.procs[0].terminate()
        try:
            return [p.wait(timeout=60) for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def test_server_tp2_answers_like_tp1(ranks):
    """Rank 0 answers /v1/completions at temperature 0 with the text and
    usage of the same flags at tp=1 (in this process); rank 1 serves no HTTP
    and stops with rank 0."""
    server = ranks["server"]
    if server.missing:
        pytest.skip(f"{server.missing} do not import")
    from aiohttp.test_utils import TestClient, TestServer

    from zhilight_tpu_torch.engine import DynamicBatchGenerator
    from zhilight_tpu_torch.server.openai import api_server as t_api
    from zhilight_tpu_torch.server.openai.serving import AsyncEngine

    args = t_api.parse_args(["--model-path", server.ckpt, *SERVER_FLAGS])
    llm = LLM(model_path=server.ckpt, device="cpu", engine_config=t_api.make_engine_config(args))
    gen = DynamicBatchGenerator(llm).start()
    try:
        async def ask():
            client = TestClient(TestServer(t_api.build_app(AsyncEngine(llm, gen), "tiny")))
            await client.start_server()
            try:
                r = await client.post("/v1/completions", json=COMPLETION)
                return await r.json()
            finally:
                await client.close()

        loop = asyncio.new_event_loop()
        try:
            want = loop.run_until_complete(ask())
        finally:
            loop.close()
    finally:
        gen.stop()

    base = f"http://127.0.0.1:{server.port}"
    deadline = time.monotonic() + 90
    while True:
        for r, p in enumerate(server.procs):
            assert p.poll() is None, f"rank {r}:\n{server.log(r)}"
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as resp:
                assert resp.status == 200
            break
        except OSError:
            assert time.monotonic() < deadline, "the tp=2 server did not come up in 90 s"
            time.sleep(0.5)
    status, got = _post(base + "/v1/completions", COMPLETION)
    assert status == 200
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["choices"][0]["finish_reason"] == want["choices"][0]["finish_reason"]
    assert got["usage"] == want["usage"]
    assert got["usage"]["completion_tokens"] >= 1
    assert server.stop() == [0, 0], f"{server.log(0)}\n{server.log(1)}"
    # rank 1 bound no port: it said so and ran the lockstep scheduler only
    assert "rank 1: serving no HTTP" in server.log(1)
    assert "Running on" not in server.log(1)
