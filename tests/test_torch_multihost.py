"""Data parallelism and multi-host serving of the port (zhilight_tpu_torch)
on the CPU: processes stand in for ranks and hosts, held against the JAX
package's engine at the same ``ParallelConfig`` on the 8 virtual CPU devices
of tests/conftest.py, with tests/test_multihost_engine.py's model, engine
configuration and requests (greedy, seeded sampled, a two-turn session).

- The plane tier: two hosts, one process and a whole replica each, no
  process group, joined by ``TcpPlane`` at ``ZT_CONTROL_ADDR``, with pool
  budgets of their own on which they agree (``all_min`` over TCP). The
  worker finishes every request with rank 0's tokens, replays the session's
  close and stops on rank 0's shutdown; rank 0's greedy tokens are the JAX
  engine's.
- The mesh tier: ``tp=2, dp=2, num_hosts=2`` as four processes with the
  variables ``torchrun --nnodes 2 --nproc-per-node 2`` sets, and ``dp=2,
  num_hosts=2`` as two processes that ``LLM`` joins from the coordinator
  address (no torchrun variables); every rank's tokens are rank 0's, and
  rank 0's the JAX engine's at ``ParallelConfig(tp=2, dp=2)`` / ``(dp=2)``.
- ``dp`` on one host: ``dp=2`` and ``tp=2, dp=2`` against the JAX engine at
  the same config; replica 1's shard bit-equal to replica 0's at the same TP
  rank; ``calc_logits`` through the loop at ``dp=2`` within 2e-4 of the JAX
  ``LLM`` at ``dp=2``.
- The plane tier with two ranks a host: ``tp=2`` on each of two hosts, each
  host a job of its own, its local rank 0 relaying over its own group what
  it takes from TCP (``RelayPlane``); tokens equal on all four ranks.
- ``TcpPlane`` in one process: ``all_min`` of unequal values, the broadcast,
  and a closed channel read as the shutdown sentinel.
- The raises, each by name: no control address (the reference's
  ``ValueError``, beside the reference's own), ``host_rank`` not below
  ``num_hosts``, ``num_hosts`` not dividing the world, torchrun's node count
  or index disagreeing, a ``LOCAL_RANK`` beyond a host's ranks, a world that
  is not ``tp * pp * dp``, a caller's group whose rank lies on another host.

The processes run tests/test_torch_tp.py's ``RANK`` script (``Ranks``, no
group of its own) with this file's cases appended: a pair (the plane tier,
then the coordinator-joined mesh tier, then ``dp=2`` on one host in the
group that made) and a quartet (the relayed plane tier, then the torchrun
mesh tier, then ``tp=2, dp=2`` on one host in its group), started together
in the background while the JAX side runs in this process.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_tp import Ranks, _free_port, _save
from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import ParallelConfig as JParallelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.parallel import control_plane as j_control_plane
from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig, ParallelConfig,
                                       SchedulerConfig)
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.parallel import control_plane as t_control_plane
from zhilight_tpu_torch.parallel.comm import LAUNCH_VARS, NODE_VARS
from zhilight_tpu_torch.parallel.control_plane import TcpPlane, control_address

# tests/test_multihost_engine.py:84-116
VOCAB, EOS = 64, 1
MODEL = dict(model_type="llama", num_layers=2, dim_model=32, num_heads=4, dim_head=8,
             num_kv_heads=2, dim_ff=64, vocab_size=VOCAB, dtype="float32")
CACHE = dict(page_size=4, num_pages=64)
SCHED = dict(max_batch=4, max_total_token=512, chunk_size=8, prefill_buckets=(8, 16, 32),
             eos_id=EOS, decode_multi_step=2)
_rng = np.random.RandomState(5)
PROMPTS = [[int(t) for t in _rng.randint(2, VOCAB, size=n)] for n in (5, 11, 19)]
SESSION = [[int(t) for t in _rng.randint(2, VOCAB, size=n)] for n in (6, 4)]
SCORE_TOKENS = [3, 9, 21, 33, 47, 5, 60, 12, 7]
# the plane tier's pool budgets, a host each: they agree on the smaller
BUDGETS = [64, 48]

# the cases of this file, run on the rank processes after RANK's own (none),
# in the order of spec["mh"]
MH_RANK = r"""
from zhilight_tpu_torch.parallel.comm import leave

out["mh"] = {}
for name, case in spec["mh"]:
    if case.get("fresh"):
        leave()  # the group of the case before is not this one's
    env = case.get("env", [{}] * world)[rank]
    os.environ.update(env)
    finished.clear()
    ModelExecutor._decide_num_pages = (
        (lambda self, n=case["budgets"][rank]: n) if case.get("budgets") else decide_num_pages)
    llm = LLM(model_config=model_config(spec["model"]), params=load(spec["params"]),
              device="cpu", engine_config=EngineConfig(
                  max_model_len=64, cache=CacheConfig(**spec["cache"]),
                  scheduler=SchedulerConfig(**spec["sched"]),
                  parallel=ParallelConfig(**case["parallel"][rank])))
    ex = llm.executor
    gen = DynamicBatchGenerator(llm).start()
    rec = dict(rank=llm.rank, world=ex.plane.world, plane=type(ex.plane).__name__,
               num_pages=ex.num_pages, kind=llm.parallel_kind,
               tp_rank=llm.tp_group.rank if llm.tp_group is not None else 0,
               group=dist.get_world_size() if dist.is_initialized() else 1,
               shards={k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                       for k, v in flat(ex.params)})
    if llm.rank == 0:
        rec["greedy"] = [r.outputs[0].token_ids for r in gen.batch_generate(
            spec["prompts"], GeneratorArg(max_length=8), timeout=100)]
        rec["sampled"] = gen.generate(spec["prompts"][0], GeneratorArg(
            max_length=6, temperature=0.8, top_p=0.9, seed=7), timeout=100).outputs[0].token_ids
        with SessionGenerator(gen) as sess:
            for turn in spec["session"]:
                sess.generate(turn, GeneratorArg(max_length=3))
        if case.get("score"):
            rec["logits"] = llm.calc_logits(spec["score"]).tolist()
        gen.stop()
    else:
        if case.get("score"):
            try:
                llm.calc_logits(spec["score"])
            except RuntimeError as e:
                rec["score_on_worker"] = str(e)
        gen.scheduler._thread.join(timeout=100)
        rec["stopped"] = not gen.scheduler._thread.is_alive()
        assert gen.scheduler.error is None, gen.scheduler.error
    rec.update(finished=dict(finished), sessions=len(gen.scheduler.sessions))
    out["mh"][name] = rec
    for key in env:
        os.environ.pop(key)
    llm = ex = gen = None
ModelExecutor._decide_num_pages = decide_num_pages

if spec.get("mh_raises"):
    def named(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    base = dict(model_config=model_config(spec["model"]), params=load(spec["params"]),
                device="cpu")
    out["mh_raises"] = {
        # the group of 2 ranks the cases left, asked for 4
        "world": named(lambda: LLM(**base, engine_config=EngineConfig(
            parallel=ParallelConfig(dp=4)))),
        # the hosts share this group, but host_rank names the other host
        "host": named(lambda: LLM(**base, engine_config=EngineConfig(
            parallel=ParallelConfig(dp=2, num_hosts=2, host_rank=1 - rank,
                                    coordinator_address="127.0.0.1:1")))),
    }
"""


def _jax_params():
    return jax.device_get(JL.init_params(JModelConfig(**MODEL), jax.random.PRNGKey(0),
                                         jnp.float32))


def _torchrun(rank: int, world: int, per_host: int, master: int) -> dict:
    """The variables ``torchrun --nnodes world/per_host --nproc-per-node
    per_host`` gives rank ``rank`` (its node the ranks' host)."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % per_host),
                LOCAL_WORLD_SIZE=str(per_host), GROUP_RANK=str(rank // per_host),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The pair and the quartet, started together, each case making its own groups."""
    tmp = tmp_path_factory.mktemp("multihost")
    base = dict(init=False, model=MODEL, params=_save(_jax_params(), tmp / "params.npz"),
                cache=CACHE, sched=SCHED, prompts=PROMPTS, session=SESSION, score=SCORE_TOKENS)
    ctrl, coord = _free_port(), _free_port()
    pair = dict(base, mh_raises=True, mh=[
        ("plane", dict(parallel=[dict(num_hosts=2, host_rank=h) for h in range(2)],
                       env=[{"ZT_CONTROL_ADDR": f"127.0.0.1:{ctrl}"}] * 2, budgets=BUDGETS)),
        ("mesh_dp2", dict(parallel=[dict(dp=2, num_hosts=2, host_rank=h,
                                         coordinator_address=f"127.0.0.1:{coord}")
                                    for h in range(2)])),
        ("dp2", dict(parallel=[dict(dp=2)] * 2, score=True)),
    ])
    hosts, relay, mesh = [_free_port(), _free_port()], _free_port(), _free_port()
    quartet = dict(base, mh=[
        # each host a torchrun job of its own (one node), its two ranks tp=2
        ("relay", dict(parallel=[dict(tp=2, num_hosts=2, host_rank=r // 2) for r in range(4)],
                       env=[dict(_torchrun(r % 2, 2, 2, hosts[r // 2]),
                                 ZT_CONTROL_ADDR=f"127.0.0.1:{relay}") for r in range(4)])),
        ("mesh_tp2_dp2", dict(fresh=True, parallel=[
            dict(tp=2, dp=2, num_hosts=2, host_rank=r // 2,
                 coordinator_address=f"127.0.0.1:{mesh}") for r in range(4)],
            env=[_torchrun(r, 4, 2, mesh) for r in range(4)])),
        ("tp2_dp2", dict(parallel=[dict(tp=2, dp=2)] * 4)),
    ])
    (tmp / "pair").mkdir()
    (tmp / "quartet").mkdir()
    return dict(pair=Ranks(pair, 2, tmp / "pair", extra=MH_RANK),
                quartet=Ranks(quartet, 4, tmp / "quartet", extra=MH_RANK))


_JAX = {}


def _jax(parallel: tuple):
    """The JAX engine at ``ParallelConfig(tp, dp)``: its greedy tokens of the
    prompts, and its LLM (made once a config)."""
    if parallel not in _JAX:
        tp, dp = parallel
        jllm = JLLM(model_config=JModelConfig(**MODEL), params=_jax_params(),
                    engine_config=JEngineConfig(max_model_len=64, cache=JCacheConfig(**CACHE),
                                                scheduler=JSchedulerConfig(**SCHED),
                                                parallel=JParallelConfig(tp=tp, dp=dp)))
        with JGenerator(jllm) as gen:
            res = gen.batch_generate(PROMPTS, JGeneratorArg(max_length=8), timeout=300)
        _JAX[parallel] = ([r.outputs[0].token_ids for r in res], jllm)
    return _JAX[parallel]


def _held(recs: list, want_tokens, plane: str, world: int):
    """Every rank finished every request (greedy, sampled, two session
    turns) with rank 0's tokens, took the session's close and stopped on
    rank 0's shutdown; rank 0's greedy tokens are ``want_tokens``."""
    r0 = recs[0]
    assert [r["rank"] for r in recs] == list(range(world))
    assert all(r["world"] == world and r["plane"] == plane for r in recs)
    assert r0["greedy"] == want_tokens and all(len(t) >= 1 for t in want_tokens)
    assert len(r0["sampled"]) == 6
    assert len(r0["finished"]) == len(PROMPTS) + 1 + len(SESSION)
    for r in recs[1:]:
        assert r["finished"] == r0["finished"], f"rank {r['rank']}"
        assert r["stopped"] and r["sessions"] == 0, f"rank {r['rank']}"


def test_plane_tier_hosts_replay_rank0(ranks):
    """Two hosts joined by TCP alone: the worker replays host 0's loop, its
    session close and its shutdown; the pool budgets (64 and 48 pages) meet
    at the smaller over TCP; the tokens are the JAX engine's at one device."""
    recs = [r["mh"]["plane"] for r in ranks["pair"].result()]
    _held(recs, _jax((1, 1))[0], "TcpPlane", 2)
    assert all(r["group"] == 1 and r["kind"] == "multi-host" for r in recs)
    assert [r["num_pages"] for r in recs] == [min(BUDGETS)] * 2
    # every host a whole replica
    assert recs[0]["shards"] == recs[1]["shards"]


@pytest.mark.parametrize("name,where,parallel", [
    ("mesh_dp2", "pair", (1, 2)),
    ("mesh_tp2_dp2", "quartet", (2, 2)),
])
def test_mesh_tier_matches_jax(ranks, name, where, parallel):
    """The hosts in one world (the coordinator-joined pair, the torchrun
    quartet): every rank finishes with rank 0's tokens, rank 0's are the JAX
    engine's at the same ParallelConfig, and each replica keeps the same
    shards."""
    recs = [r["mh"][name] for r in ranks[where].result()]
    tp, dp = parallel
    _held(recs, _jax(parallel)[0], "DistPlane", tp * dp)
    assert all(r["group"] == tp * dp for r in recs)
    for r in recs[tp:]:
        assert r["tp_rank"] == r["rank"] % tp
        assert r["shards"] == recs[r["rank"] % tp]["shards"]


@pytest.mark.parametrize("name,where,parallel", [
    ("dp2", "pair", (1, 2)),
    ("tp2_dp2", "quartet", (2, 2)),
])
def test_dp_on_one_host_matches_jax(ranks, name, where, parallel):
    """``dp=2`` and ``tp=2, dp=2`` on one host: the JAX engine's tokens at
    the same config (which are its one-device tokens too), replica 1's shard
    bit-equal to replica 0's at the same TP rank, and at tp=2 each replica's
    two ranks holding halves (shards that differ)."""
    recs = [r["mh"][name] for r in ranks[where].result()]
    tp, dp = parallel
    want, _ = _jax(parallel)
    assert want == _jax((1, 1))[0]
    _held(recs, want, "DistPlane", tp * dp)
    assert all(r["kind"] == ("tensor-parallel" if tp > 1 else "data-parallel") for r in recs)
    for r in recs[tp:]:
        assert r["shards"] == recs[r["rank"] % tp]["shards"], f"rank {r['rank']}"
    if tp > 1:
        assert recs[0]["shards"] != recs[1]["shards"]


def test_dp2_scoring_through_the_loop_matches_jax(ranks):
    recs = [r["mh"]["dp2"] for r in ranks["pair"].result()]
    want = np.asarray(_jax((1, 2))[1].calc_logits(SCORE_TOKENS))
    got = np.asarray(recs[0]["logits"])
    assert got.shape == (len(SCORE_TOKENS), VOCAB)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert "rank 1 of a data-parallel LLM takes no scoring calls" in recs[1]["score_on_worker"]


def test_relayed_plane_tier_tokens_on_every_rank(ranks):
    """Two hosts of two ranks (tp=2 each), each host its own job: host 1's
    local rank 0 relays host 0's events to its other rank; all four finish
    with rank 0's tokens, the JAX engine's at tp=2."""
    recs = [r["mh"]["relay"] for r in ranks["quartet"].result()]
    _held(recs, _jax((2, 1))[0], "RelayPlane", 4)
    # each host's own group of two; the hosts' shards alike
    assert all(r["group"] == 2 and r["tp_rank"] == r["rank"] % 2 for r in recs)
    assert recs[2]["shards"] == recs[0]["shards"] and recs[3]["shards"] == recs[1]["shards"]


def test_rank_raises(ranks):
    for rank, r in enumerate(ranks["pair"].result()):
        assert r["mh_raises"]["world"] == "the process group has 2 ranks; tp=1 x dp=4 asks for 4"
        assert r["mh_raises"]["host"] == (f"rank {rank} of 2 lies on host {rank} of 2; "
                                          f"host_rank is {1 - rank}")


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_tcp_plane_all_min_broadcast_and_shutdown():
    """Three hosts on the loopback: ``all_min`` of unequal budgets is the
    least on every host, a broadcast reaches both workers, and once rank 0
    closes the channel a worker's broadcast returns None (shutdown)."""
    addr = f"127.0.0.1:{_free_port()}"
    got, errors = {}, []

    def worker(rank, budget):
        try:
            plane = TcpPlane(rank, 3, addr, timeout=30)
            got[rank] = [plane.all_min(budget), plane.broadcast(None), plane.broadcast(None)]
            plane.close()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r, b)) for r, b in ((1, 40), (2, 96))]
    for t in threads:
        t.start()
    plane = TcpPlane(0, 3, addr, timeout=30)
    assert plane.all_min(64) == 40
    assert plane.broadcast({"events": [1, 2]}) == {"events": [1, 2]}
    plane.close()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    assert got == {1: [40, {"events": [1, 2]}, None], 2: [40, {"events": [1, 2]}, None]}


def test_control_address_rules_are_the_reference():
    """``ZT_CONTROL_ADDR`` over the coordinator's port + 17 (the reference's
    offset), an explicit address over both; none of them: the reference's
    ValueError."""
    assert t_control_plane.CONTROL_PORT_OFFSET == j_control_plane.CONTROL_PORT_OFFSET == 17
    pcfg = ParallelConfig(num_hosts=2, coordinator_address="10.1.2.3:1234")
    with pytest.MonkeyPatch.context() as m:
        m.delenv("ZT_CONTROL_ADDR", raising=False)
        assert control_address(pcfg) == "10.1.2.3:1251"
        assert control_address(pcfg, "h:9") == "h:9"
        m.setenv("ZT_CONTROL_ADDR", "10.9.9.9:7")
        assert control_address(pcfg) == "10.9.9.9:7"
        assert control_address(pcfg, "h:9") == "h:9"


@pytest.fixture
def no_launch(monkeypatch):
    for var in LAUNCH_VARS + NODE_VARS + ("ZT_CONTROL_ADDR",):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _llm(**parallel):
    return LLM(model_config=ModelConfig(**MODEL), params=_jax_params(), device="cpu",
               engine_config=EngineConfig(max_model_len=64, cache=CacheConfig(**CACHE),
                                          scheduler=SchedulerConfig(**SCHED),
                                          parallel=ParallelConfig(**parallel)))


def test_plane_tier_without_an_address_raises_as_the_reference(no_launch):
    msg = "multi-host serving needs coordinator_address"
    with pytest.raises(ValueError, match=msg):
        j_control_plane.make_control_plane(JParallelConfig(num_hosts=2))
    with pytest.raises(ValueError, match=msg):
        t_control_plane.make_control_plane(ParallelConfig(num_hosts=2))
    with pytest.raises(ValueError, match=msg):
        _llm(num_hosts=2)


@pytest.mark.parametrize("what,parallel,env,message", [
    ("host_rank", dict(num_hosts=2, host_rank=2), {}, "host_rank 2 is not below num_hosts 2"),
    ("host_rank_one_host", dict(host_rank=1), {}, "host_rank 1 is not below num_hosts 1"),
    ("hosts_divide", dict(tp=2, num_hosts=4, coordinator_address="127.0.0.1:1"), {},
     "num_hosts=4 does not divide the world of 2 ranks"),
    ("torchrun_nodes", dict(tp=2, dp=2), _torchrun(1, 4, 2, 1),
     "torchrun launched 2 nodes; num_hosts=1 asks for 1"),
    ("torchrun_nodes_plane", dict(tp=2, num_hosts=2, host_rank=1), _torchrun(3, 4, 2, 1),
     "torchrun launched 2 nodes; num_hosts=2 asks for 1"),
    ("torchrun_node_rank", dict(tp=2, dp=2, num_hosts=2, host_rank=0,
                                coordinator_address="127.0.0.1:1"), _torchrun(3, 4, 2, 1),
     "torchrun's GROUP_RANK is 1; host_rank is 0"),
    ("local_rank", dict(dp=2, num_hosts=2, host_rank=0, coordinator_address="127.0.0.1:1"),
     dict(LOCAL_RANK="1"), "LOCAL_RANK 1: a host runs 1 of the 2 ranks"),
])
def test_host_configuration_raises_by_name(what, parallel, env, message, no_launch):
    """Before any group is joined or any rank waits on another."""
    for key, value in env.items():
        no_launch.setenv(key, value)
    with pytest.raises(ValueError, match=message):
        _llm(**parallel)
