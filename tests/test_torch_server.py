"""The port's OpenAI server (zhilight_tpu_torch.server.openai) on the CPU.

The first four tests are tests/test_openai_server.py's, against the port's
``build_app``: a 2-layer fp32 model (the JAX package's ``init_params``
weights) behind a char-level toy tokenizer. The finish-line tests serve the
verify recipe's checkpoint (tools/make_tiny_model.py: a 2-layer llama, head_dim
16, with a byte-level BPE tokenizer and a chat template) from both packages'
servers in one process, built from each package's own ``parse_args`` and
``make_engine_config`` with the recipe's flags, greedy: the completion, the
chat completion and the streamed chat completion have identical text,
finish_reason and usage, the streams end in ``[DONE]``, the embeddings agree
and ``/metrics`` shows the same ``zhilight_*`` names. Both packages serve
every checkpoint that is not float16 in bf16 (``config/adapters.py:63`` of
each), the recipe's float32 one included: its embeddings (the mean of the
last hidden states) agree to 2e-2, a few bf16 steps at their size (up to 4).
The same tests run again with both models in float32 (the dtype the
checkpoint declares), where the embeddings agree to 1e-4. The command
line (``python -m zhilight_tpu_torch.server.openai.api_server --device
cpu``) serves the recipe as the in-process server does, and raises without
``--device`` on a machine with no GPU.
"""

import asyncio
import dataclasses
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

pytest.importorskip("aiohttp")
pytest.importorskip("pydantic")

from aiohttp.test_utils import TestClient, TestServer

from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.server.openai import api_server as j_api
from zhilight_tpu.server.openai.serving import AsyncEngine as JAsyncEngine
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, ModelConfig, SchedulerConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.server.openai import api_server as t_api
from zhilight_tpu_torch.server.openai.serving import AsyncEngine

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 64
EOS = 1
# the verify recipe's server flags (.claude/skills/verify/SKILL.md)
RECIPE = ["--max-model-len", "256", "--dyn-max-batch-size", "4", "--chunk-size", "64"]


def run_async(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class ToyTokenizer:
    """Char-level tokenizer: byte -> token id (mod vocab), decoding to chars."""

    eos_token_id = EOS

    def encode(self, text):
        return [2 + (ord(c) % (VOCAB - 2)) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + (int(i) % 26)) for i in ids if int(i) >= 2)

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True, **kw):
        text = "".join(m["content"] or "" for m in messages)
        return self.encode(text)


@pytest.fixture(scope="module")
def served():
    cfg = dict(model_type="llama", num_layers=2, dim_model=32, num_heads=4, dim_head=8,
               num_kv_heads=2, dim_ff=64, vocab_size=VOCAB, dtype="float32")
    from zhilight_tpu.config import ModelConfig as JModelConfig

    params = jax.device_get(JL.init_params(JModelConfig(**cfg), jax.random.PRNGKey(0),
                                           jnp.float32))
    ecfg = EngineConfig(
        max_model_len=64,
        cache=CacheConfig(page_size=4, num_pages=64),
        scheduler=SchedulerConfig(max_batch=4, chunk_size=16, prefill_buckets=(16, 32),
                                  eos_id=EOS),
    )
    llm = LLM(model_config=ModelConfig(**cfg), params=params, engine_config=ecfg,
              tokenizer=ToyTokenizer(), device="cpu")
    gen = DynamicBatchGenerator(llm).start()
    try:
        engine = AsyncEngine(llm, gen)
        # aiohttp apps freeze once served: hand each test a fresh app
        yield lambda: t_api.build_app(engine, "tiny-llama", api_key=None)
    finally:
        gen.stop()


async def _client(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def test_health_models_version(served):
    run_async(_test_health_models_version(served))


async def _test_health_models_version(served):
    client = await _client(served())
    try:
        r = await client.get("/health")
        assert r.status == 200
        r = await client.get("/v1/models")
        data = await r.json()
        assert data["data"][0]["id"] == "tiny-llama"
        r = await client.get("/version")
        assert (await r.json())["version"]
        r = await client.get("/metrics")
        assert r.status == 200
    finally:
        await client.close()


def test_chat_completion(served):
    run_async(_test_chat_completion(served))


async def _test_chat_completion(served):
    client = await _client(served())
    try:
        r = await client.post(
            "/v1/chat/completions",
            json={"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 8},
        )
        assert r.status == 200, await r.text()
        data = await r.json()
        assert data["object"] == "chat.completion"
        assert data["choices"][0]["message"]["role"] == "assistant"
        assert data["usage"]["completion_tokens"] > 0
    finally:
        await client.close()


def test_chat_completion_stream(served):
    run_async(_test_chat_completion_stream(served))


async def _test_chat_completion_stream(served):
    client = await _client(served())
    try:
        r = await client.post(
            "/v1/chat/completions",
            json={"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
                  "stream": True},
        )
        assert r.status == 200
        body = await r.text()
        chunks = [l[len("data: "):] for l in body.splitlines() if l.startswith("data: ")]
        assert chunks[-1] == "[DONE]"
        parsed = [json.loads(c) for c in chunks[:-1]]
        assert parsed[0]["choices"][0]["delta"].get("role") == "assistant"
        assert parsed[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    finally:
        await client.close()


def test_completions(served):
    run_async(_test_completions(served))


async def _test_completions(served):
    client = await _client(served())
    try:
        r = await client.post("/v1/completions", json={"prompt": "abc", "max_tokens": 5})
        assert r.status == 200, await r.text()
        data = await r.json()
        assert data["object"] == "text_completion"
        assert isinstance(data["choices"][0]["text"], str)
    finally:
        await client.close()


# ---------------------------------------------------------------------------
# the finish line: the verify recipe's checkpoint behind both servers
# ---------------------------------------------------------------------------

def make_tiny(path: str) -> str:
    """tools/make_tiny_model.py's checkpoint in ``path``."""
    spec = importlib.util.spec_from_file_location("make_tiny_model",
                                                  ROOT / "tools" / "make_tiny_model.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    maker.make(path)
    return path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    return make_tiny(str(tmp_path_factory.mktemp("tiny-llama")))


def _apps(tiny, dtype=None):
    """(port app factory, JAX app factory) over the recipe's checkpoint, in
    ``dtype`` where one is given."""
    from zhilight_tpu.config import load_model_config as j_load
    from zhilight_tpu_torch.config import load_model_config as t_load

    tcfg, jcfg = t_load(tiny)[0], j_load(tiny)[0]
    if dtype:
        tcfg, jcfg = dataclasses.replace(tcfg, dtype=dtype), dataclasses.replace(jcfg, dtype=dtype)
    tllm = LLM(model_path=tiny, device="cpu", model_config=tcfg,
               engine_config=t_api.make_engine_config(
                   t_api.parse_args(["--model-path", tiny, "--device", "cpu", *RECIPE])))
    jllm = JLLM(model_path=tiny, model_config=jcfg, engine_config=j_api.make_engine_config(
        j_api.parse_args(["--model-path", tiny, *RECIPE])))
    tgen = DynamicBatchGenerator(tllm).start()
    jgen = JGenerator(jllm).start()
    try:
        tengine, jengine = AsyncEngine(tllm, tgen), JAsyncEngine(jllm, jgen)
        yield (lambda: t_api.build_app(tengine, "tiny-llama"),
               lambda: j_api.build_app(jengine, "tiny-llama"))
    finally:
        tgen.stop()
        jgen.stop()


@pytest.fixture(scope="module")
def recipe_apps(tiny):
    yield from _apps(tiny)


@pytest.fixture(scope="module")
def float32_apps(tiny):
    yield from _apps(tiny, "float32")


# embedding tolerance of each pair: bf16 rounding, or fp32 sums in another order
EMBED_TOL = {"recipe_apps": 2e-2, "float32_apps": 1e-4}


@pytest.fixture(params=list(EMBED_TOL))
def both(request):
    return request.getfixturevalue(request.param)


def _both(both, fn):
    """``fn(client)`` against the port's server, then the JAX server's."""

    async def go():
        out = []
        for app in both:
            client = await _client(app())
            try:
                out.append(await fn(client))
            finally:
                await client.close()
        return out

    return run_async(go())


def _sse(body: str):
    chunks = [l[len("data: "):] for l in body.splitlines() if l.startswith("data: ")]
    assert chunks[-1] == "[DONE]"
    return [json.loads(c) for c in chunks[:-1]]


COMPLETION = {"prompt": "hello world", "max_tokens": 8, "temperature": 0}
CHAT = {"messages": [{"role": "user", "content": "the quick brown fox"}], "max_tokens": 12,
        "temperature": 0}


def test_finish_line_completions(both):
    async def fn(client):
        r = await client.post("/v1/completions", json=COMPLETION)
        assert r.status == 200, await r.text()
        data = await r.json()
        c = data["choices"][0]
        return c["text"], c["finish_reason"], data["usage"]

    got, want = _both(both, fn)
    assert got == want
    assert got[2]["completion_tokens"] > 0 and got[2]["prompt_tokens"] > 0


def test_finish_line_chat(both):
    async def fn(client):
        r = await client.post("/v1/chat/completions", json=CHAT)
        assert r.status == 200, await r.text()
        data = await r.json()
        c = data["choices"][0]
        return c["message"]["content"], c["finish_reason"], data["usage"]

    got, want = _both(both, fn)
    assert got == want
    assert got[2]["completion_tokens"] > 0


def test_finish_line_chat_stream(both):
    async def streamed(client):
        r = await client.post("/v1/chat/completions", json=dict(CHAT, stream=True))
        assert r.status == 200
        parsed = _sse(await r.text())
        assert parsed[0]["choices"][0]["delta"].get("role") == "assistant"
        text = "".join(p["choices"][0]["delta"].get("content") or "" for p in parsed)
        return text, parsed[-1]["choices"][0]["finish_reason"], parsed[-1]["usage"]

    async def fn(client):
        r = await client.post("/v1/chat/completions", json=CHAT)
        whole = (await r.json())["choices"][0]["message"]["content"]
        return await streamed(client), whole

    (got, got_whole), (want, want_whole) = _both(both, fn)
    assert got == want
    assert got[0] == got_whole == want_whole


def test_finish_line_completion_stream(both):
    async def fn(client):
        r = await client.post("/v1/completions", json=dict(COMPLETION, stream=True))
        assert r.status == 200
        return "".join(p["choices"][0]["text"] for p in _sse(await r.text()))

    got, want = _both(both, fn)
    assert got == want


def test_finish_line_embeddings(both, request):
    async def fn(client):
        r = await client.post("/v1/embeddings", json={"input": ["hello world", "the lazy dog"]})
        assert r.status == 200, await r.text()
        data = await r.json()
        return [d["embedding"] for d in data["data"]], data["usage"]

    (got, got_usage), (want, want_usage) = _both(both, fn)
    assert got_usage == want_usage
    tol = EMBED_TOL[request.node.callspec.params["both"]]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _metric_names(text: str):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE zhilight_")}


def test_finish_line_metrics_names(both):
    async def fn(client):
        await client.post("/v1/completions", json=COMPLETION)
        r = await client.get("/metrics")
        assert r.status == 200
        return await r.text()

    got, want = _both(both, fn)
    assert _metric_names(got) == _metric_names(want)
    assert "zhilight_generation_tokens_total" in _metric_names(got)


def test_recipe_checkpoint_dtype_is_read_as_the_reference_reads_it(tiny):
    """The checkpoint declares float32 under ``dtype`` (this transformers'
    key; older ones wrote ``torch_dtype``): both packages serve it in bf16."""
    import json as _json

    from zhilight_tpu.config import load_model_config as j_load
    from zhilight_tpu_torch.config import load_model_config as t_load

    raw = _json.loads((Path(tiny) / "config.json").read_text())
    assert raw.get("dtype", raw.get("torch_dtype")) == "float32"
    assert t_load(tiny)[0].dtype == j_load(tiny)[0].dtype == "bfloat16"


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def test_cli_serves_the_recipe(tiny, recipe_apps):
    """``python -m zhilight_tpu_torch.server.openai.api_server --device cpu``
    with the recipe's flags answers /health and returns the in-process
    servers' completion."""

    async def fn(client):
        r = await client.post("/v1/completions", json=COMPLETION)
        return (await r.json())["choices"][0]["text"]

    want = _both(recipe_apps, fn)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "zhilight_tpu_torch.server.openai.api_server",
         "--model-path", tiny, "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         *RECIPE],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-4000:]
            try:
                status, _ = _get(base + "/health", timeout=5)
                break
            except OSError:
                assert time.monotonic() < deadline, "the server did not come up in 120 s"
                time.sleep(0.5)
        assert status == 200
        status, body = _get(base + "/v1/completions", COMPLETION)
        assert status == 200
        data = json.loads(body)
        assert [data["choices"][0]["text"]] * 2 == want
        assert data["choices"][0]["finish_reason"] in ("stop", "length")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_cli_without_device_raises_without_gpu(tiny, monkeypatch):
    """No silent move to the CPU: the server's default device is the GPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.main(["--model-path", tiny, "--no-warmup", *RECIPE])


@pytest.mark.parametrize("flags", [["-tp", "2"], ["-dp", "2"], ["-pp", "2"], ["--nnodes", "2"],
                                   ["--node-rank", "1"]])
def test_parallel_flags_are_not_ported(flags, monkeypatch):
    """Every parallel flag is served (tests/test_torch_tp.py,
    tests/test_torch_pp.py, tests/test_torch_multihost.py); without the
    launch it needs, each raises by name before the model is read: tensor,
    pipeline and data parallelism name torchrun, a second host with no
    coordinator and no ``ZT_CONTROL_ADDR`` raises the reference's
    ``ValueError``, and a node rank beyond the node count raises too. With
    the plane's address given, ``--nnodes 2`` gives its ParallelConfig."""
    args = t_api.parse_args(["--model-path", "unused", "--device", "cpu", *flags])
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "ZT_CONTROL_ADDR"):
        monkeypatch.delenv(var, raising=False)
    if flags[0] in ("-tp", "-dp", "-pp"):
        with pytest.raises(RuntimeError, match="torchrun"):
            t_api.make_engine_config(args)
        return
    if flags[0] == "--nnodes":
        with pytest.raises(ValueError, match="multi-host serving needs coordinator_address"):
            t_api.make_engine_config(args)
        monkeypatch.setenv("ZT_CONTROL_ADDR", "127.0.0.1:29517")
        parallel = t_api.make_engine_config(args).parallel
        assert (parallel.num_hosts, parallel.host_rank) == (2, 0)
        assert parallel.coordinator_address is None
        return
    with pytest.raises(ValueError, match="host_rank 1 is not below num_hosts 1"):
        t_api.make_engine_config(args)
