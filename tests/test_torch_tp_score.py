"""Scoring, SmoothQuant calibration and W8A8 quantization with calibrated
scales under tensor parallelism in the port (zhilight_tpu_torch) on the CPU:
one process a rank over gloo, held against the single-process port and
against the JAX package's ``ParallelConfig(tp=2)`` on the 8 virtual CPU
devices of tests/conftest.py, in fp32.

- Scoring: ``calc_logits``, ``calc_hidden_states``, ``calc_log_prob``,
  ``calc_loss`` and ``calc_greedy_match`` on rank 0 of a TP=2 ``LLM``, run
  by every rank's scheduler loop as an event, within 2e-4 of the JAX
  ``LLM``'s at tp=2 and of the single-process port's, for a dense model with
  biases on every linear and for tests/test_torch_tp_moe.py's tiny
  DeepSeek-V2 (MLA, a dense first layer, 8 experts top 2, a shared expert).
  In the same run one score is submitted at the loop's first decode step and
  runs while the greedy requests decode: their tokens are the JAX engine's
  at tp=2, and the score is the one taken with the loop idle, bit for bit.
- Wrong use raises by name and never waits: a scoring call on rank 1, on
  rank 0 before its loop starts and after it stops, ``calc_act_scales``
  while the loop runs; a scoring event that fails on every rank ends every
  rank's loop and raises in rank 0's caller.
- Calibration: ``calc_act_scales`` called on both ranks returns whole
  vectors, bit-equal between the ranks, within 1e-4 of the JAX ``LLM``'s at
  tp=2 and of the single-process port's, for the dense model and a Qwen2-MoE
  model (a dense first layer, then 4 experts and a gated shared expert).
- Quantization: ``quantize_int8_params(shard, scales, alpha, tp=group)`` is
  bit-equal to the shard of the whole tree quantized with the same scales,
  on codes, scales and ``smooth``, over separate and fused ``qkv_proj`` /
  ``gate_up_proj`` leaves with biases; a planted fault (the weight rows'
  maximum not reduced) gives other codes.
- ``LLM.load_with_smooth_quant`` at TP=2 from tests/test_torch_tp.py's
  checkpoint, in fp32, against the JAX ``load_with_smooth_quant`` at tp=2:
  each rank's smooth vectors are its slice of the reference's within 1e-4,
  the greedy tokens are identical, and the logits agree by
  tests/test_torch_w8a8.py's rule for W8A8 models (1e-3 of the largest
  logit on all rows but a few, 5e-2 on those): an activation on a rounding
  boundary takes the neighbouring int8 code on one side, and the reference
  at tp=2 parts from itself at tp=1 so, by 5.6e-3 of the largest logit on
  one row of this input.

The rank processes are tests/test_torch_tp.py's (``Ranks``, its ``RANK``
script), one pair for every case, running :data:`SCORE` after the script's
own cases while the JAX side runs in this process.
"""

import dataclasses

import numpy as np
import pytest

import torch

from test_torch_tp import (ENG_MODEL, ENG_SCHED, PROMPTS, Ranks, _checkpoint, _flat, _jax_tokens,
                           _load, _params, _save, _tree)
from test_torch_tp_moe import jax_tree
from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import MoEConfig as JMoEConfig
from zhilight_tpu.config import ParallelConfig as JParallelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.config import load_model_config as j_load_model_config
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig, MoEConfig,
                                       SchedulerConfig, load_model_config)
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.parallel.sharding import shard_params
from zhilight_tpu_torch.utils.convert import params_to_torch
from zhilight_tpu_torch.utils.quant_convert import quantize_int8_params

TOL = dict(rtol=2e-4, atol=2e-4)
ALPHA = 0.5
# every linear with a bias, row-parallel ones included
DENSE = dict(ENG_MODEL, model_type="qwen2", attn_bias=True)
MOE = dict(ENG_MODEL, model_type="qwen2_moe")
MOE_CFG = dict(num_experts=4, top_k=2, intermediate_size=64, shared_expert_intermediate_size=64,
               shared_expert_gate=True, first_k_dense_replace=1)
CALIB_LEN = 24
_rng = np.random.RandomState(9)
CALIB = [[int(t) for t in _rng.randint(2, 64, size=n)] for n in (11, 17)]
SCORE_TOKENS = {"dense": [int(t) for t in _rng.randint(0, 64, size=19)],
                "mla": [int(t) for t in _rng.randint(0, 128, size=19)]}

# ---------------------------------------------------------------------------
# the rank side: run by tests/test_torch_tp.py's RANK script after its cases
# ---------------------------------------------------------------------------

SCORE = r"""
import threading
from zhilight_tpu_torch.engine.task import TaskStatus
from zhilight_tpu_torch.utils import quant_convert as QC

out_dir = os.path.dirname(out_path)


def raised(fn):
    # [what fn raised, or None; the seconds it took]
    t0 = time.monotonic()
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return [f"{type(e).__name__}: {e}", time.monotonic() - t0]
    return [None, time.monotonic() - t0]


def save(path, tree):
    np.savez(path, **{k: v.numpy() for k, v in flat(tree)})


out["score"] = {}
for name, case in spec["score"].items():
    llm = LLM(model_config=model_config(case["model"]), params=load(case["params"]),
              engine_config=engine_config(case, world), device="cpu")
    ex, toks = llm.executor, case["tokens"]
    rec = dict(no_loop=raised(lambda: llm.calc_logits(toks)))
    gen = DynamicBatchGenerator(llm)
    sched = gen.scheduler
    # every scoring event this rank's loop runs, with the slots decoding then
    # and whether a decode window was in flight
    events, run_score = [], ex.run_score
    def recorded(tokens, _kind="score"):
        events.append([_kind, sum(t is not None and t.status == TaskStatus.DECODE
                                  for t in sched.slots), sched._pending is not None])
        return run_score(tokens, _kind)
    ex.run_score = recorded
    if case.get("fail"):
        def planted(tokens, _kind="score"):
            raise RuntimeError("planted scoring fault")
        ex.run_score = planted
    gen.start()
    if case.get("fail"):
        if rank == 0:
            rec["caller"] = raised(lambda: llm.calc_logits(toks))
        sched._thread.join(timeout=60)
        rec.update(alive=sched._thread.is_alive(), error=repr(sched.error))
        if rank == 0:
            gen.stop()
        out["score"][name] = rec
        continue
    if rank == 0:
        rec["logits"] = llm.calc_logits(toks).tolist()
        rec["hidden"] = llm.calc_hidden_states(toks).tolist()
        rec["log_prob"] = list(llm.calc_log_prob(toks))
        rec["loss"] = llm.calc_loss(toks)
        rec["greedy_match"] = llm.calc_greedy_match(toks)
        # one score asked for from another thread at the loop's first decode
        # step: the loop takes it at its next iteration, the requests decoding
        mid, decode = {}, sched._decode_step
        def first_decode():
            decode()
            if "thread" not in mid:
                mid["thread"] = threading.Thread(
                    target=lambda: mid.update(logits=llm.calc_logits(toks)))
                mid["thread"].start()
                deadline = time.monotonic() + 30
                while not sched._score_requests and time.monotonic() < deadline:
                    time.sleep(0.001)
        sched._decode_step = first_decode
        rec["greedy"] = [r.outputs[0].token_ids for r in gen.batch_generate(
            case["prompts"], GeneratorArg(**case["arg"]), timeout=100)]
        mid["thread"].join(timeout=60)
        rec["mid_equal"] = bool(np.array_equal(mid["logits"], np.asarray(rec["logits"],
                                                                          np.float32)))
        rec["act_scales_in_loop"] = raised(lambda: llm.calc_act_scales([[3, 4, 5]]))
        gen.stop()
        rec["stopped"] = raised(lambda: llm.calc_logits(toks))
    else:
        rec["rank1"] = raised(lambda: llm.calc_logits(toks))
        rec["rank1_hidden"] = raised(lambda: llm.calc_hidden_states(toks))
        rec["act_scales_in_loop"] = raised(lambda: llm.calc_act_scales([[3, 4, 5]]))
        sched._thread.join(timeout=100)
        assert not sched._thread.is_alive() and sched.error is None, sched.error
    rec.update(events=events, finished=dict(finished))
    finished.clear()
    out["score"][name] = rec

# calc_act_scales, a collective call outside the loop
for name, case in spec["calib"].items():
    llm = LLM(model_config=model_config(case["model"]), params=load(case["params"]),
              engine_config=engine_config(case, world), device="cpu")
    np.savez(f"{out_dir}/scales_{name}_rank{rank}.npz",
             **llm.calc_act_scales(case["prompts"], calib_len=case["calib_len"]))

# a rank's shard quantized with the whole act vectors; then with the rows'
# weight maximum left unreduced (a planted fault)
qc = spec["quant"]
shard = params_to_torch(shard_params(load(qc["params"]), rank, world,
                                     cfg=model_config(qc["model"])), "cpu", torch.float32)
scales = dict(np.load(qc["scales"]))
save(f"{out_dir}/quant_rank{rank}.npz", QC.quantize_int8_params(shard, scales, qc["alpha"],
                                                                 tp=group))
smooth = QC.smooth_quant_weights
QC.smooth_quant_weights = lambda w, act, alpha=0.5, reduce=None: smooth(w, act, alpha)
save(f"{out_dir}/quant_fault_rank{rank}.npz", QC.quantize_int8_params(shard, scales, qc["alpha"],
                                                                       tp=group))
QC.smooth_quant_weights = smooth

# the SmoothQuant flow from a checkpoint, every rank calling it
sq = spec["smooth"]
llm = LLM.load_with_smooth_quant(sq["model_path"], sq["calib"],
                                 engine_config=engine_config(sq, world), alpha=sq["alpha"],
                                 calib_len=sq["calib_len"], device="cpu",
                                 model_config=model_config(sq["model"]))
rec = dict(leaves={k: [str(v.dtype), list(v.shape)] for k, v in flat(llm.executor.params)})
np.savez(f"{out_dir}/smooth_rank{rank}.npz", **{k: v.numpy() for k, v in flat(llm.executor.params)
                                                if k.endswith(".smooth")})
gen = DynamicBatchGenerator(llm).start()
if rank == 0:
    rec["logits"] = llm.calc_logits(sq["tokens"]).tolist()
    rec["greedy"] = [r.outputs[0].token_ids for r in gen.batch_generate(
        sq["prompts"], GeneratorArg(**sq["arg"]), timeout=100)]
    gen.stop()
else:
    gen.scheduler._thread.join(timeout=100)
out["smooth"] = rec
"""


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _case(model, params_path, tokens, **extra):
    return dict(dict(model=model, params=params_path, env={}, max_model_len=64,
                     cache=dict(page_size=4, num_pages=64), sched=ENG_SCHED, prompts=PROMPTS,
                     arg=dict(max_length=8), tokens=tokens), **extra)


def _fused(params):
    """``params`` with layer 0's q/k/v and gate/up fused into ``qkv_proj`` and
    ``gate_up_proj`` (weights and biases), layer 1's left apart."""
    layer = dict(params["layers"]["0"])
    attn, mlp = dict(layer["attn"]), dict(layer["mlp"])
    parts = [attn.pop(n) for n in ("q_proj", "k_proj", "v_proj")]
    attn["qkv_proj"] = {k: np.concatenate([p[k] for p in parts], axis=-1) for k in ("w", "b")}
    parts = [mlp.pop(n) for n in ("gate_proj", "up_proj")]
    mlp["gate_up_proj"] = {k: np.concatenate([p[k] for p in parts], axis=-1) for k in ("w", "b")}
    return dict(params, layers=dict(params["layers"], **{"0": dict(layer, attn=attn, mlp=mlp)}))


def _scales(params, seed):
    """Random whole act vectors (positive, a few outliers) for every linear
    of a dense tree, keyed by path."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, layer in params["layers"].items():
        for group in ("attn", "mlp"):
            for name, p in layer[group].items():
                v = np.exp(rng.randn(p["w"].shape[0])).astype(np.float32)
                v[rng.randint(0, len(v), 3)] *= 20
                out[f"layers.{i}.{group}.{name}"] = v
    return out


def _moe_configs():
    jcfg = JModelConfig(**dict(MOE, moe=JMoEConfig(**MOE_CFG)))
    tcfg = ModelConfig(**dict(MOE, moe=MoEConfig(**MOE_CFG)))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_score")
    dense = _params(JModelConfig(**DENSE), biases=True)
    dense_path = _save(dense, tmp / "dense.npz")
    mla_tree, mla_jcfg, mla_tcfg = jax_tree("dense")
    mla_path = _save(mla_tree, tmp / "mla.npz")
    moe_jcfg, moe_tcfg = _moe_configs()
    moe_path = _save(_params(moe_jcfg), tmp / "moe.npz")
    fused = _fused(dense)
    scales = _scales(fused, 4)
    np.savez(tmp / "quant_scales.npz", **scales)
    ckpt = _checkpoint(tmp / "checkpoint")
    vocab = load_model_config(ckpt)[0].vocab_size
    rng = np.random.RandomState(13)
    smooth = dict(model_path=ckpt, model=dataclasses.asdict(_smooth_configs(ckpt)[1]),
                  max_model_len=64, cache=dict(page_size=4, num_pages=64), sched=ENG_SCHED,
                  calib=[rng.randint(2, vocab, size=n).tolist() for n in (9, 14)],
                  calib_len=CALIB_LEN, alpha=ALPHA,
                  tokens=rng.randint(0, vocab, size=17).tolist(),
                  prompts=[rng.randint(2, vocab, size=n).tolist() for n in (5, 13)],
                  arg=dict(max_length=8))
    spec = dict(
        score={"dense": _case(DENSE, dense_path, SCORE_TOKENS["dense"]),
               "mla": _case(dataclasses.asdict(mla_tcfg), mla_path, SCORE_TOKENS["mla"]),
               "fail": _case(DENSE, dense_path, SCORE_TOKENS["dense"], fail=True)},
        calib={"dense": _case(DENSE, dense_path, [], prompts=CALIB, calib_len=CALIB_LEN),
               "moe": _case(dataclasses.asdict(moe_tcfg), moe_path, [], prompts=CALIB,
                            calib_len=CALIB_LEN)},
        quant=dict(model=DENSE, params=_save(fused, tmp / "fused.npz"),
                   scales=str(tmp / "quant_scales.npz"), alpha=ALPHA),
        smooth=smooth)
    (tmp / "ranks").mkdir()
    yield dict(pair=Ranks(spec, 2, tmp / "ranks", extra=SCORE), dir=tmp / "ranks", spec=spec,
               configs={"dense": (None, ModelConfig(**DENSE)), "mla": (mla_jcfg, mla_tcfg),
                        "moe": (moe_jcfg, moe_tcfg)},
               whole={"dense": dense, "mla": mla_tree, "fused": fused}, scales=scales)


def _smooth_configs(ckpt):
    """Both packages' configurations of the checkpoint, in fp32 (each serves
    a float32 checkpoint in bf16 unless told)."""
    return (j_load_model_config(ckpt)[0].replace(dtype="float32"),
            load_model_config(ckpt)[0].replace(dtype="float32"))


def _engine(cls_engine, cls_cache, cls_sched, parallel=None):
    kw = dict(parallel=parallel) if parallel is not None else {}
    return cls_engine(max_model_len=64, cache=cls_cache(page_size=4, num_pages=64),
                      scheduler=cls_sched(**ENG_SCHED), **kw)


def _one(name, ranks):
    """The single-process port's LLM of a scoring case."""
    case = ranks["spec"]["score"][name]
    return LLM(model_config=ranks["configs"][name][1], params=_tree(_load(case["params"])),
               device="cpu", engine_config=_engine(EngineConfig, CacheConfig, SchedulerConfig))


def _scores(llm, tokens):
    return dict(logits=llm.calc_logits(tokens), hidden=llm.calc_hidden_states(tokens),
                log_prob=llm.calc_log_prob(tokens), loss=llm.calc_loss(tokens),
                greedy_match=llm.calc_greedy_match(tokens))


@pytest.fixture(scope="module")
def references(ranks):
    """Per scoring case: the JAX engine's greedy tokens at tp=2, the JAX
    LLM's scores at tp=2 (the same LLM) and the single-process port's."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in ("dense", "mla"):
            case = ranks["spec"]["score"][name]
            tokens, jllm = _jax_tokens(case, mp, jcfg=ranks["configs"][name][0])
            out[name] = dict(tokens=tokens, jax=_scores(jllm, case["tokens"]),
                             one=_scores(_one(name, ranks), case["tokens"]))
    finally:
        mp.undo()
    return out


def _rank(ranks, r):
    return ranks["pair"].result()[r]


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["logits", "hidden", "log_prob", "loss", "greedy_match"])
@pytest.mark.parametrize("name", ["dense", "mla"])
def test_scoring_matches_jax_tp2_and_one_process(ranks, references, name, what):
    got = _rank(ranks, 0)["score"][name][what]
    for side in ("jax", "one"):
        want = references[name][side][what]
        if what == "log_prob":
            np.testing.assert_allclose(got[0], want[0], **TOL)
            np.testing.assert_allclose(got[1], want[1], **TOL)
        elif what == "greedy_match":
            assert got == want, side
        else:
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=side, **TOL)


@pytest.mark.parametrize("name", ["dense", "mla"])
def test_score_between_decode_windows_keeps_the_tokens(ranks, references, name):
    """The score asked for at the first decode step runs on both ranks while
    the requests decode; their tokens are the JAX engine's at tp=2, both
    ranks finish them alike, and that score equals the idle one."""
    r0, r1 = (_rank(ranks, r)["score"][name] for r in range(2))
    assert r0["greedy"] == references[name]["tokens"]
    assert r0["finished"] and r0["finished"] == r1["finished"]
    assert r0["mid_equal"]
    # both ranks ran the same events in the same order: five scores with the
    # loop idle, then one with requests decoding
    assert r0["events"] == r1["events"]
    kinds = [e[0] for e in r0["events"]]
    assert kinds == ["score", "hidden", "score", "score", "score", "score"], kinds
    assert all(e[1] == 0 for e in r0["events"][:5]) and r0["events"][5][1] > 0


# ---------------------------------------------------------------------------
# wrong use
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,rank,message", [
    ("no_loop", 0, "start every rank's generator"),
    ("stopped", 0, "start every rank's generator"),
    ("rank1", 1, "rank 1 of a tensor-parallel LLM takes no scoring calls"),
    ("rank1_hidden", 1, "rank 1 of a tensor-parallel LLM takes no scoring calls"),
    ("act_scales_in_loop", 0, "outside the scheduler loop"),
    ("act_scales_in_loop", 1, "outside the scheduler loop"),
])
def test_wrong_use_raises_by_name_at_once(ranks, what, rank, message):
    msg, seconds = _rank(ranks, rank)["score"]["dense"][what]
    assert msg is not None and msg.startswith("RuntimeError") and message in msg, msg
    assert seconds < 5


def test_failed_scoring_event_ends_every_loop(ranks):
    """A scoring event that raises on every rank fails every rank's loop, as
    a model step's failure does, and rank 0's caller gets the error."""
    r0, r1 = (_rank(ranks, r)["score"]["fail"] for r in range(2))
    msg, seconds = r0["caller"]
    assert msg == "RuntimeError: planted scoring fault" and seconds < 30
    for r in (r0, r1):
        assert not r["alive"] and "planted scoring fault" in r["error"]


# ---------------------------------------------------------------------------
# calibration and quantization
# ---------------------------------------------------------------------------

def _jax_act_scales(jcfg, params):
    jllm = JLLM(model_config=jcfg, params=params,
                engine_config=_engine(JEngineConfig, JCacheConfig, JSchedulerConfig,
                                      parallel=JParallelConfig(tp=2)))
    return jllm.calc_act_scales(CALIB, calib_len=CALIB_LEN)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_act_scales_are_whole_and_match_jax_tp2(ranks, name):
    case = ranks["spec"]["calib"][name]
    _rank(ranks, 0)
    got = [dict(np.load(ranks["dir"] / f"scales_{name}_rank{r}.npz")) for r in range(2)]
    params = _tree(_load(case["params"]))
    jcfg = JModelConfig(**DENSE) if name == "dense" else ranks["configs"]["moe"][0]
    want = _jax_act_scales(jcfg, params)
    one = LLM(model_config=ModelConfig(**DENSE) if name == "dense" else ranks["configs"]["moe"][1],
              params=params, device="cpu",
              engine_config=_engine(EngineConfig, CacheConfig, SchedulerConfig)).calc_act_scales(
                  CALIB, calib_len=CALIB_LEN)
    assert sorted(got[0]) == sorted(want) == sorted(one)
    assert "layers.0.attn.o_proj" in want and "layers.0.mlp.down_proj" in want
    for key in want:
        # the whole [in] vector on both ranks, bit for bit
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
        assert got[0][key].shape == want[key].shape == one[key].shape
        np.testing.assert_allclose(got[0][key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(got[0][key], one[key], rtol=1e-4, atol=1e-4, err_msg=key)


def _quantized_whole_shards(ranks):
    cfg = ModelConfig(**DENSE)
    whole = quantize_int8_params(params_to_torch(ranks["whole"]["fused"], "cpu", torch.float32),
                                 ranks["scales"], ALPHA)
    return [dict(_flat(shard_params(whole, r, 2, cfg))) for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_calibrated_shard_is_the_shard_of_the_whole(ranks, rank):
    _rank(ranks, 0)
    want = _quantized_whole_shards(ranks)[rank]
    got = dict(np.load(ranks["dir"] / f"quant_rank{rank}.npz"))
    assert sorted(got) == sorted(want)
    quantized = [k for k in want if k.endswith(".w_q")]
    assert {k.rsplit(".", 2)[-2] for k in quantized} == {
        "qkv_proj", "q_proj", "k_proj", "v_proj", "o_proj", "gate_up_proj", "gate_proj",
        "up_proj", "down_proj"}
    for key, value in want.items():
        assert torch.equal(torch.from_numpy(got[key]), value), key
    # every linear carries its smooth vector (row-parallel: its rows' slice)
    for key in quantized:
        assert key[:-len("w_q")] + "smooth" in got, key


def test_planted_unreduced_weight_max_is_caught(ranks):
    """With each row's weight maximum left to the rank's columns, a
    column-parallel shard's codes or smooth vector part from the whole's;
    row-parallel ones, which hold every column, stay equal."""
    _rank(ranks, 0)
    want = _quantized_whole_shards(ranks)
    parted = set()
    for r in range(2):
        got = dict(np.load(ranks["dir"] / f"quant_fault_rank{r}.npz"))
        parted |= {k for k, v in want[r].items() if not torch.equal(torch.from_numpy(got[k]), v)}
    assert parted and all(".o_proj." not in k and ".down_proj." not in k for k in parted), parted
    assert any(".qkv_proj." in k for k in parted) and any(".gate_up_proj." in k for k in parted)


# ---------------------------------------------------------------------------
# load_with_smooth_quant
# ---------------------------------------------------------------------------

def test_load_with_smooth_quant_matches_jax_tp2(ranks):
    sq = ranks["spec"]["smooth"]
    jcfg, _ = _smooth_configs(sq["model_path"])
    jllm = JLLM.load_with_smooth_quant(
        sq["model_path"], sq["calib"], alpha=ALPHA, calib_len=CALIB_LEN, model_config=jcfg,
        engine_config=_engine(JEngineConfig, JCacheConfig, JSchedulerConfig,
                              parallel=JParallelConfig(tp=2)))
    want = jllm.calc_logits(sq["tokens"])
    with JGenerator(jllm) as gen:
        tokens = [r.outputs[0].token_ids for r in gen.batch_generate(
            sq["prompts"], JGeneratorArg(**sq["arg"]), timeout=300)]
    r0 = _rank(ranks, 0)["smooth"]
    # each rank keeps its int8 shard, with its smooth vectors: a
    # row-parallel linear's its rows' slice of the reference's
    leaves = r0["leaves"]
    assert leaves["layers.0.attn.q_proj.w_q"][0] == "torch.int8"
    for r in range(2):
        smooth = dict(np.load(ranks["dir"] / f"smooth_rank{r}.npz"))
        assert len(smooth) == 2 * 7, sorted(smooth)
        for key, got in smooth.items():
            i, part, name = key.split(".")[1:4]
            ref = np.asarray(jllm.executor.params["layers"][i][part][name]["smooth"])
            if name in ("o_proj", "down_proj"):
                ref = ref[r * len(got):(r + 1) * len(got)]
            np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=key)
    assert r0["greedy"] == tokens and all(len(t) >= 1 for t in tokens)
    got = np.asarray(r0["logits"])
    rows = np.abs(got - want).max(axis=1) / np.abs(want).max()
    assert (rows <= 1e-3).sum() >= len(rows) - 3 and rows.max() <= 5e-2, rows
