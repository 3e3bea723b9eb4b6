"""Pipeline parallelism of the port (zhilight_tpu_torch) on the CPU: one
process a rank over gloo, a stage's layers a rank (``ParallelConfig(pp=P)``,
alone or with ``tp``), held against the JAX package's engine at the same
``ParallelConfig`` on the 8 virtual CPU devices of tests/conftest.py and
against the single-process port.

- Against the JAX engine, greedy tokens equal in fp32: ``pp=2`` over a qwen2
  model with a bias on every linear, ``pp=2`` over an int8 pool, ``pp=2``
  with GPTQ int4 linears, and ``tp=2, pp=2``; ``calc_logits`` and
  ``calc_hidden_states`` at ``pp=2``, through the scheduler loop, within
  2e-4 (tests/test_pp_engine.py's bound).
- Against the single-process port: ``pp=4``; ``pp=2`` with input
  embeddings; ``pp=2`` under ``ZT_WINDOW_KV=1``, which takes no side window
  (no window step, no flush); swap and recompute preemption at ``pp=2`` on a
  pool of 8 pages. Every rank finishes every request with rank 0's tokens, a
  seeded sampled one included, holds its stage's layers only, in a pool of
  those layers, and the page count is the reference's.
- The raises, each by name: MLA, MoE, ``num_layers % pp``, ``dp`` with
  ``pp``, a world that is not ``tp * pp``, and ``calc_act_scales`` /
  ``load_with_smooth_quant`` under ``pp=2``, beside the JAX ``LLM``, whose
  ``calc_act_scales`` fails there too (``KeyError``).
- A planted fault, caught: a stage that indexes its pool by the global layer
  index.
- The server: ``api_server --pipeline-parallel 2`` as two processes with
  torchrun's variables answers ``/v1/completions`` and ``/v1/embeddings`` as
  ``pp=1`` does; ``--data-parallel 2``, once refused, answers
  ``/v1/completions`` as ``dp=1`` does.

The rank processes are tests/test_torch_tp.py's (``Ranks``, its ``RANK``
script with this file's cases appended), one pair and one quartet started
together in the background while the JAX side runs in this process.
"""

import asyncio
import queue
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_tp import (COMPLETION, EMBEDDING, ENG_MODEL, ENG_SCHED, FWD_MODEL,
                           PRESSURE_PROMPTS, PRESSURE_SCHED, PROMPTS, SERVER_FLAGS, Ranks,
                           TPServer, _params, _post)
from test_torch_tp_quant import _fp8_npz, _gptq_tree
from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import ParallelConfig as JParallelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, MLAConfig, ModelConfig,
                                       MoEConfig, ParallelConfig, SchedulerConfig)
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.kvcache.paged import new_kv_cache
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import PrefillMeta
from zhilight_tpu_torch.models.pipeline import PPForwards
from zhilight_tpu_torch.parallel.comm import LAUNCH_VARS
from zhilight_tpu_torch.parallel.sharding import (is_shard, rank_params, stage_params,
                                                  stage_range)
from zhilight_tpu_torch.utils.convert import params_to_torch

# four layers at head_dim 64 (both packages' packed head-major pool), so that
# pp=4 holds one layer a stage
PP_MODEL = dict(ENG_MODEL, num_layers=4)
BIAS_MODEL = dict(PP_MODEL, model_type="qwen2", attn_bias=True)
SCORE_TOKENS = [3, 9, 21, 33, 47, 5, 60, 12, 7]
SAMPLED = dict(max_length=6, temperature=0.8, top_p=0.9, seed=7)
PRESSURE_CACHE = dict(page_size=4, num_pages=8)

# name -> (model, weights, parallel, what holds it: "jax" or "port", options)
CASES = {
    "biases": (BIAS_MODEL, "biases", dict(pp=2), "jax", dict(extras=True)),
    "int8": (PP_MODEL, "dense", dict(pp=2), "jax", dict(cache=dict(kv_dtype="int8"))),
    "gptq": (FWD_MODEL, "gptq", dict(pp=2), "jax", {}),
    "embeddings": (PP_MODEL, "dense", dict(pp=2), "port", dict(embeddings=True)),
    "window": (PP_MODEL, "dense", dict(pp=2), "port", dict(env={"ZT_WINDOW_KV": "1"})),
    "swap": (PP_MODEL, "dense", dict(pp=2), "port", dict(pressure="swap")),
    "recompute": (PP_MODEL, "dense", dict(pp=2), "port", dict(pressure="recompute")),
    "tp2_pp2": (PP_MODEL, "dense", dict(tp=2, pp=2), "jax", {}),
    "pp4": (PP_MODEL, "dense", dict(pp=4), "port", {}),
}

# the cases of this file, run on the rank processes after RANK's own (none)
PP_RANK = r"""
flushes = [0]
_flush = L.flush_window_rows
def _counted_flush(*a, **kw):
    flushes[0] += 1
    return _flush(*a, **kw)
L.flush_window_rows = _counted_flush


def pp_llm(case, parallel):
    return LLM(model_config=model_config(case["model"]), params=load(case["params"]),
               device="cpu", engine_config=EngineConfig(
                   max_model_len=64, cache=CacheConfig(**case["cache"]),
                   scheduler=SchedulerConfig(**case["sched"]),
                   parallel=ParallelConfig(**parallel)))


def raises(fn):
    try:
        fn()
    except (NotImplementedError, ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


out["pp"], out["pp_raises"] = {}, {}
for name, case in spec.get("pp", {}).items():
    os.environ.pop("ZT_WINDOW_KV", None)
    os.environ.update(case["env"])
    finished.clear()
    window_steps[0] = flushes[0] = 0
    llm = pp_llm(case, case["parallel"])
    ex = llm.executor
    rec = dict(rank=llm.rank, layers=sorted(int(k) for k in ex.params["layers"]),
               pool_layers=len(ex.cache.k), stage=ex.pp.stage, stages=ex.pp.stages,
               heads=ex.cfg.num_kv_heads, num_pages=ex.num_pages,
               kv_bytes=ex._kv_bytes_per_token(), window_kv=ex.window_kv,
               fused_chunk=ex.supports_fused_chunk, packed_prefill=ex.supports_packed_prefill)
    if case["extras"]:
        # collective only in the loop: calibration raises by name at once
        rec["act_scales"] = raises(lambda: llm.calc_act_scales([[3, 4, 5, 6]]))
    gen = DynamicBatchGenerator(llm).start()
    if rank == 0:
        arg = GeneratorArg(**case["arg"])
        if case["embeddings"] is not None:
            rec["greedy"] = [gen.generate(p, arg, input_embeddings=np.asarray(e, np.float32),
                                          timeout=100).outputs[0].token_ids
                             for p, e in zip(case["prompts"], case["embeddings"])]
        else:
            rec["greedy"] = [r.outputs[0].token_ids for r in gen.batch_generate(
                case["prompts"], arg, timeout=100)]
        if case["extras"]:
            rec["sampled"] = gen.generate(case["prompts"][0], GeneratorArg(**case["sampled"]),
                                          timeout=100).outputs[0].token_ids
            rec["logits"] = llm.calc_logits(case["score"]).tolist()
            rec["hidden"] = llm.calc_hidden_states(case["score"]).tolist()
        gen.stop()
    else:
        gen.scheduler._thread.join(timeout=100)
        assert not gen.scheduler._thread.is_alive(), f"rank {rank}'s scheduler did not stop"
        assert gen.scheduler.error is None, gen.scheduler.error
        if case["extras"]:
            rec["score_on_worker"] = raises(lambda: llm.calc_logits(case["score"]))
    rec.update(finished=dict(finished), preemptions=gen.scheduler.num_preemptions,
               window_steps=window_steps[0], flushes=flushes[0])
    out["pp"][name] = rec
    llm = ex = gen = None
os.environ.pop("ZT_WINDOW_KV", None)

if spec.get("pp_raises"):
    case = spec["pp_raises"]
    out["pp_raises"]["world_not_tp_pp"] = raises(lambda: pp_llm(case, dict(pp=2 * world)))
"""


def _weights(kind, model):
    if kind == "gptq":
        return _gptq_tree(1)
    return _params(JModelConfig(**model), seed=5, biases=kind == "biases")


def _embeddings(tree, prompts):
    """Each prompt's token embeddings plus 0.1: rows no token gives."""
    table = np.asarray(tree["embedding"]["w"], np.float32)
    return [(table[p] + 0.1).tolist() for p in prompts]


def _case(name, trees, paths):
    model, kind, parallel, _, opts = CASES[name]
    case = dict(model=dict(model), params=paths[kind], parallel=parallel,
                env=opts.get("env", {}), extras=opts.get("extras", False), embeddings=None,
                score=SCORE_TOKENS, sampled=SAMPLED)
    if "pressure" in opts:
        case.update(cache=PRESSURE_CACHE, sched=dict(PRESSURE_SCHED, preempt_mode=opts["pressure"]),
                    prompts=PRESSURE_PROMPTS, arg=dict(max_length=20))
    else:
        case.update(cache=dict(dict(page_size=4, num_pages=64), **opts.get("cache", {})),
                    sched=ENG_SCHED, prompts=PROMPTS, arg=dict(max_length=8))
    if opts.get("embeddings"):
        case["embeddings"] = _embeddings(trees[kind], case["prompts"])
    return case


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The rank processes, started together: a pair for every pp=2 case and
    the raises, a quartet for tp=2 x pp=2 and pp=4, and two servers' two
    ranks each (pp=2, dp=2); the weights beside."""
    tmp = tmp_path_factory.mktemp("pp")
    trees, paths = {}, {}
    for name, (model, kind, *_) in CASES.items():
        if kind not in trees:
            trees[kind] = _weights(kind, model)
            paths[kind] = _fp8_npz(trees[kind], tmp / f"{kind}.npz")
    cases = {name: _case(name, trees, paths) for name in CASES}
    w2 = {n: c for n, c in cases.items() if c["parallel"].get("tp", 1) * c["parallel"]["pp"] == 2}
    w4 = {n: c for n, c in cases.items() if n not in w2}
    for sub in ("w2", "w4"):
        (tmp / sub).mkdir()
    running = {
        "w2": Ranks(dict(pp=w2, pp_raises=cases["swap"]), 2, tmp / "w2", extra=PP_RANK),
        "w4": Ranks(dict(pp=w4), 4, tmp / "w4", extra=PP_RANK),
        "server": TPServer(tmp / "server", parallel=("--pipeline-parallel", "2")),
        "dp_server": TPServer(tmp / "dp_server", parallel=("--data-parallel", "2")),
        "cases": cases,
        "trees": trees,
    }
    yield running
    running["server"].stop()
    running["dp_server"].stop()


def _results(ranks, name):
    par = ranks["cases"][name]["parallel"]
    world = "w2" if par.get("tp", 1) * par["pp"] == 2 else "w4"
    return [r["pp"][name] for r in ranks[world].result()]


def _jax_run(case, tree):
    """The JAX engine's greedy tokens at the case's ParallelConfig, and its LLM."""
    jllm = JLLM(model_config=JModelConfig(**case["model"]), params=tree,
                engine_config=JEngineConfig(max_model_len=64, cache=JCacheConfig(**case["cache"]),
                                            scheduler=JSchedulerConfig(**case["sched"]),
                                            parallel=JParallelConfig(**case["parallel"])))
    with JGenerator(jllm) as gen:
        res = gen.batch_generate(case["prompts"], JGeneratorArg(**case["arg"]), timeout=300)
    return [r.outputs[0].token_ids for r in res], jllm


def _port_run(case, tree, monkeypatch):
    """The single-process port's greedy tokens (and, with the case's extras,
    its sampled tokens)."""
    with monkeypatch.context() as m:
        m.delenv("ZT_WINDOW_KV", raising=False)
        llm = LLM(model_config=ModelConfig(**case["model"]), params=tree, device="cpu",
                  engine_config=EngineConfig(max_model_len=64, cache=CacheConfig(**case["cache"]),
                                             scheduler=SchedulerConfig(**case["sched"])))
        with DynamicBatchGenerator(llm) as gen:
            arg = GeneratorArg(**case["arg"])
            if case["embeddings"] is not None:
                greedy = [gen.generate(p, arg, input_embeddings=np.asarray(e, np.float32),
                                       timeout=100).outputs[0].token_ids
                          for p, e in zip(case["prompts"], case["embeddings"])]
            else:
                greedy = [r.outputs[0].token_ids
                          for r in gen.batch_generate(case["prompts"], arg, timeout=100)]
            sampled = gen.generate(case["prompts"][0], GeneratorArg(**case["sampled"]),
                                   timeout=100).outputs[0].token_ids
    return greedy, sampled, llm


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _check_ranks(case, recs):
    """What every rank of a case must show: rank 0's tokens finished on every
    rank; each holds its stage's layers only, in a pool of those layers; the
    page count and its bytes a token are the reference's (every layer, the
    KV heads divided by tp); no fused chunk, no packed prefill."""
    model, par = case["model"], case["parallel"]
    tp, pp = par.get("tp", 1), par["pp"]
    L = model["num_layers"]
    r0 = recs[0]
    assert r0["finished"] and all(r["finished"] == r0["finished"] for r in recs)
    for world_rank, r in enumerate(recs):
        stage = world_rank // tp
        assert (r["rank"], r["stage"], r["stages"]) == (world_rank, stage, pp)
        assert r["layers"] == list(range(*stage_range(ModelConfig(**model), stage, pp)))
        assert r["pool_layers"] == L // pp
        assert r["heads"] == model["num_kv_heads"] // tp
        assert r["num_pages"] == case["cache"]["num_pages"]
        itemsize = 4 if case["cache"].get("kv_dtype") != "int8" else 1
        rows = L * 2 * model["num_kv_heads"] // tp
        assert r["kv_bytes"] == rows * model["dim_head"] * itemsize + (
            rows * 4 if itemsize == 1 else 0)
        assert not r["fused_chunk"] and not r["packed_prefill"]


JAX_CASES = [n for n, c in CASES.items() if c[3] == "jax"]
PORT_CASES = [n for n, c in CASES.items() if c[3] == "port"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_engine_tokens_match_jax(ranks, name):
    """Greedy tokens equal to the JAX engine's at the same ParallelConfig
    (pp=2 over biases, an int8 pool and int4 linears; tp=2 x pp=2); the
    biases case also scores through rank 0's loop at pp=2, within 2e-4 of
    the JAX LLM's ``calc_logits`` and ``calc_hidden_states``, whose
    ``calc_act_scales`` fails at pp=2 (``KeyError``), as the port's raises
    by name."""
    case = ranks["cases"][name]
    tree = ranks["trees"][CASES[name][1]]
    want, jllm = _jax_run(case, tree)
    recs = _results(ranks, name)
    assert recs[0]["greedy"] == want and all(len(t) >= 1 for t in want)
    _check_ranks(case, recs)
    if not case["extras"]:
        return
    np.testing.assert_allclose(np.asarray(recs[0]["logits"]), jllm.calc_logits(SCORE_TOKENS),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(recs[0]["hidden"]),
                               jllm.calc_hidden_states(SCORE_TOKENS), rtol=2e-4, atol=2e-4)
    with pytest.raises(KeyError):
        jllm.calc_act_scales([[3, 4, 5, 6]])
    for r in recs:
        assert r["act_scales"].startswith("NotImplementedError") and "pipeline" in r["act_scales"]
    assert "rank 1 of a pipeline-parallel LLM takes no scoring calls" in recs[1]["score_on_worker"]


@pytest.mark.parametrize("name", PORT_CASES)
def test_engine_tokens_match_single_process(ranks, name, monkeypatch):
    """Greedy tokens equal to the single-process port's: pp=4, pp=2 with
    input embeddings, pp=2 under ZT_WINDOW_KV=1 (no side window: the steps
    decode one at a time, nothing flushed), swap and recompute preemption at
    pp=2 (a preemption on every rank)."""
    case = ranks["cases"][name]
    want, _, _ = _port_run(case, params_to_torch(ranks["trees"][CASES[name][1]], "cpu"),
                           monkeypatch)
    recs = _results(ranks, name)
    assert recs[0]["greedy"] == want and all(len(t) >= 1 for t in want)
    _check_ranks(case, recs)
    if name == "window":
        assert all(r["window_kv"] and r["window_steps"] == 0 and r["flushes"] == 0 for r in recs)
    if "preempt_mode" in case["sched"]:
        assert all(r["preemptions"] > 0 for r in recs)


def test_ranks_agree_on_a_sampled_request(ranks, monkeypatch):
    """A seeded sampled request at pp=2: every rank samples the same logits
    with the same generators, so every rank finishes it with rank 0's
    tokens, which are the single-process port's."""
    case = ranks["cases"]["biases"]
    _, want, _ = _port_run(case, params_to_torch(ranks["trees"]["biases"], "cpu"), monkeypatch)
    recs = _results(ranks, "biases")
    assert recs[0]["sampled"] == want
    assert all(want in r["finished"].values() for r in recs)


# ---------------------------------------------------------------------------
# the stage's tree
# ---------------------------------------------------------------------------

def test_stage_tree_cuts_and_is_recognised():
    """A stage keeps its layers under their global keys beside the
    embedding, the final norm and the head; ``init_params(stage=...)`` gives
    the full draw's slice, ``shard=`` with it the TP shard of that slice;
    ``is_shard`` recognises a stage tree and a TP-sharded one, and
    ``rank_params`` cuts only what a tree still needs."""
    cfg = ModelConfig(**PP_MODEL)
    full = TL.init_params(cfg, 3, "cpu")
    for stage in range(2):
        lo, hi = stage_range(cfg, stage, 2)
        part = TL.init_params(cfg, 3, "cpu", stage=(stage, 2))
        assert sorted(part["layers"]) == [str(i) for i in range(lo, hi)]
        cut = stage_params(full, stage, 2)
        for key in ("embedding", "final_norm", "lm_head"):
            assert torch.equal(part[key]["w"], full[key]["w"])
        for i in range(lo, hi):
            assert torch.equal(part["layers"][str(i)]["mlp"]["up_proj"]["w"],
                               cut["layers"][str(i)]["mlp"]["up_proj"]["w"])
        assert is_shard(part, cfg, 1, 2) and not is_shard(full, cfg, 1, 2)
        both = TL.init_params(cfg, 3, "cpu", shard=(1, 2), stage=(stage, 2))
        assert is_shard(both, cfg, 2, 2) and not is_shard(part, cfg, 2, 2)
        for tree in (full, part, TL.init_params(cfg, 3, "cpu", shard=(1, 2))):
            got = rank_params(tree, cfg, 1, 2, stage, 2)
            assert sorted(got["layers"]) == sorted(both["layers"])
            for i in range(lo, hi):
                assert torch.equal(got["layers"][str(i)]["attn"]["k_proj"]["w"],
                                   both["layers"][str(i)]["attn"]["k_proj"]["w"])


def test_loader_reads_only_the_stage_layers(tmp_path):
    """``load_hf_state(..., layers=)`` reads a stage's layers only (the
    others never leave the checkpoint), composes with ``shard=``, and
    gives the stage's slice of the whole."""
    from zhilight_tpu_torch.utils import hf_loader as TH

    cfg = ModelConfig(**PP_MODEL)
    d, f, V = cfg.dim_model, cfg.dim_ff, cfg.vocab_size
    g = torch.Generator().manual_seed(0)
    state = {"model.embed_tokens.weight": torch.randn(V, d, generator=g),
             "model.norm.weight": torch.ones(d), "lm_head.weight": torch.randn(V, d, generator=g)}
    q, kv = cfg.num_heads * cfg.dim_head, cfg.num_kv_heads * cfg.dim_head
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (q, d)), ("self_attn.k_proj", (kv, d)),
                            ("self_attn.v_proj", (kv, d)), ("self_attn.o_proj", (d, q)),
                            ("mlp.gate_proj", (f, d)), ("mlp.up_proj", (f, d)),
                            ("mlp.down_proj", (d, f))):
            state[pre + name + ".weight"] = torch.randn(*shape, generator=g)
        state[pre + "input_layernorm.weight"] = torch.ones(d)
        state[pre + "post_attention_layernorm.weight"] = torch.ones(d)
    torch.save(state, tmp_path / "pytorch_model.bin")
    whole = TH.load_hf_state(str(tmp_path), cfg, dtype=torch.float32)
    read = []
    real = TH._iter_torch_bin

    def counted(path, keep=None):
        for name, t in real(path, keep):
            read.append(name)
            yield name, t

    TH._iter_torch_bin = counted
    try:
        got = TH.load_hf_state(str(tmp_path), cfg, dtype=torch.float32, layers=(2, 4),
                               shard=(1, 2))
    finally:
        TH._iter_torch_bin = real
    assert not any(n.startswith(("model.layers.0.", "model.layers.1.")) for n in read)
    assert sorted(got["layers"]) == ["2", "3"]
    want = rank_params(whole, cfg, 1, 2, 1, 2)
    for i in ("2", "3"):
        assert torch.equal(got["layers"][i]["attn"]["q_proj"]["w"],
                           want["layers"][i]["attn"]["q_proj"]["w"])
    assert torch.equal(got["embedding"]["w"], want["embedding"]["w"])


# ---------------------------------------------------------------------------
# a planted fault
# ---------------------------------------------------------------------------

class _Column:
    """Two stages of one column in this process, one thread a stage, their
    moves through queues (a stand-in for ``parallel.comm.PPGroup``)."""

    def __init__(self, stage, links):
        self.stage, self.stages = stage, 2
        self.first, self.last = stage == 0, stage == 1
        self.links = links

    def send(self, x):
        self.links["hand"].put(x.clone())

    def recv(self, shape, dtype, device):
        return self.links["hand"].get(timeout=30)

    def from_last(self, x, shape, dtype, device):
        if self.last:
            self.links["back"].put(x.clone())
            return x
        return self.links["back"].get(timeout=30)


def _two_stages(cfg, params):
    """A 2-stage prefill of SCORE_TOKENS, each stage its layers and a pool of
    those layers; returns stage 0's and stage 1's logits, or raises what a
    stage raised."""
    n = len(SCORE_TOKENS)
    i32 = dict(dtype=torch.int32)
    rows = torch.arange(n, **i32)
    meta = PrefillMeta(positions=rows, slot_mapping=rows, page_table=torch.arange(4, **i32),
                       cache_len=torch.tensor(0, **i32), q_len=torch.tensor(n, **i32))
    rope = TL.build_rope(cfg)
    links = {"hand": queue.Queue(), "back": queue.Queue()}
    got = {}

    def stage(s):
        try:
            fwd = PPForwards(_Column(s, links), stage_range(cfg, s, 2))
            cache = new_kv_cache(cfg.num_layers // 2, 4, 4, cfg.num_kv_heads, cfg.dim_head,
                                 torch.float32)
            with torch.no_grad():
                got[s] = fwd.forward_prefill(stage_params(params, s, 2), cfg, rope,
                                             torch.tensor(SCORE_TOKENS, **i32), meta, cache)[0]
        except BaseException as e:  # noqa: BLE001 - re-raised below
            got[s] = e
            links["back"].put(torch.zeros(n, cfg.dim_model))

    threads = [threading.Thread(target=stage, args=(s,)) for s in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for s in range(2):
        if isinstance(got[s], BaseException):
            raise got[s]
    return got[0], got[1]


def test_planted_global_pool_index_is_caught(monkeypatch):
    """Two stages in threads give the single-process logits bit for bit on
    both; the planted fault, a stage that indexes its pool (of its own
    layers, as the executor builds it) by the global layer index, fails."""
    cfg = ModelConfig(**PP_MODEL)
    params = TL.init_params(cfg, 1, "cpu")
    n = len(SCORE_TOKENS)
    i32 = dict(dtype=torch.int32)
    rows = torch.arange(n, **i32)
    meta = PrefillMeta(positions=rows, slot_mapping=rows, page_table=torch.arange(4, **i32),
                       cache_len=torch.tensor(0, **i32), q_len=torch.tensor(n, **i32))
    with torch.no_grad():
        want, _ = TL.forward_prefill(params, cfg, TL.build_rope(cfg),
                                     torch.tensor(SCORE_TOKENS, **i32), meta,
                                     new_kv_cache(cfg.num_layers, 4, 4, cfg.num_kv_heads,
                                                  cfg.dim_head, torch.float32))
    s0, s1 = _two_stages(cfg, params)
    assert torch.equal(s0, want) and torch.equal(s1, want)
    real = TL.decoder_layer
    monkeypatch.setattr(TL, "decoder_layer", lambda *a, pool_idx=None, **kw: real(*a, **kw))
    with pytest.raises(IndexError):
        _two_stages(cfg, params)


# ---------------------------------------------------------------------------
# the raises
# ---------------------------------------------------------------------------

MLA = dict(model_type="deepseek_v2", num_layers=4, dim_model=32, num_heads=4, dim_head=12,
           num_kv_heads=4, dim_ff=64, vocab_size=64, dtype="float32",
           mla=MLAConfig(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8))
MOE = dict(PP_MODEL, model_type="qwen2_moe",
           moe=MoEConfig(num_experts=4, top_k=2, intermediate_size=32))


@pytest.mark.parametrize("what,model,parallel,error,message", [
    ("mla", MLA, dict(pp=2), ValueError, "pipeline parallelism needs homogeneous layers"),
    ("moe", MOE, dict(pp=2), ValueError, "pipeline parallelism needs homogeneous layers"),
    ("layers", dict(PP_MODEL, num_layers=3), dict(pp=2), ValueError, "num_layers 3 % pp 2"),
    ("dp", PP_MODEL, dict(pp=2, dp=2), NotImplementedError, "pp does not compose with dp"),
])
def test_what_pp_does_not_serve_raises(what, model, parallel, error, message, monkeypatch):
    """The reference's raises (zhilight_tpu/engine/engine.py:104-110), by
    name, before any process group is joined."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(error, match=message):
        LLM(model_config=ModelConfig(**model), params={}, device="cpu",
            engine_config=EngineConfig(parallel=ParallelConfig(**parallel)))


def test_smooth_quant_under_pp_raises_before_reading():
    with pytest.raises(NotImplementedError, match="load_with_smooth_quant under pipeline"):
        LLM.load_with_smooth_quant("unused", [[3, 4]], engine_config=EngineConfig(
            parallel=ParallelConfig(pp=2)))


def test_rank_raises(ranks):
    """On the ranks: a world of 2 asked for pp=4."""
    for r in ranks["w2"].result():
        msg = r["pp_raises"]["world_not_tp_pp"]
        assert msg is not None and msg.startswith("ValueError")
        assert "the process group has 2 ranks; tp=1 x pp=4 asks for 4" in msg


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_server_pp2_answers_like_pp1(ranks):
    """Rank 0 of ``--pipeline-parallel 2`` answers /v1/completions at
    temperature 0 with the text and usage of the same flags at pp=1 (in
    this process), and /v1/embeddings within 2e-2 (both serve the float32
    checkpoint in bf16); rank 1 serves no HTTP and stops with rank 0.
    ``--data-parallel 2`` (two processes, a replica each) answers
    /v1/completions with the same text and usage; its rank 1 serves no HTTP
    and stops with its rank 0."""
    server, dp_server = ranks["server"], ranks["dp_server"]
    if server.missing:
        pytest.skip(f"{server.missing} do not import")
    from aiohttp.test_utils import TestClient, TestServer

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
                e = await client.post("/v1/embeddings", json=EMBEDDING)
                return await r.json(), await e.json()
            finally:
                await client.close()

        loop = asyncio.new_event_loop()
        try:
            want, want_emb = loop.run_until_complete(ask())
        finally:
            loop.close()
    finally:
        gen.stop()
    base = _serving(server, "pp=2")
    status, got = _post(base + "/v1/completions", COMPLETION)
    assert status == 200
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"] and got["usage"]["completion_tokens"] >= 1
    status, emb = _post(base + "/v1/embeddings", EMBEDDING)
    assert status == 200 and emb["usage"] == want_emb["usage"]
    np.testing.assert_allclose(np.asarray([d["embedding"] for d in emb["data"]]),
                               np.asarray([d["embedding"] for d in want_emb["data"]]),
                               rtol=2e-2, atol=2e-2)
    assert server.stop() == [0, 0], f"{server.log(0)}\n{server.log(1)}"
    assert "pipeline-parallel rank 1: serving no HTTP" in server.log(1)
    assert "Running on" not in server.log(1)
    status, got = _post(_serving(dp_server, "dp=2") + "/v1/completions", COMPLETION)
    assert status == 200
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]
    assert dp_server.stop() == [0, 0], f"{dp_server.log(0)}\n{dp_server.log(1)}"
    assert "data-parallel rank 1: serving no HTTP" in dp_server.log(1)
    assert "Running on" not in dp_server.log(1)


def _serving(server, what: str) -> str:
    """The base URL of ``server``'s rank 0 once /health answers (90 s at
    most; a rank that exits fails at once)."""
    base = f"http://127.0.0.1:{server.port}"
    deadline = time.monotonic() + 90
    while True:
        for r, p in enumerate(server.procs):
            assert p.poll() is None, f"rank {r}:\n{server.log(r)}"
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as resp:
                assert resp.status == 200
            return base
        except OSError:
            assert time.monotonic() < deadline, f"the {what} server did not come up in 90 s"
            time.sleep(0.5)
