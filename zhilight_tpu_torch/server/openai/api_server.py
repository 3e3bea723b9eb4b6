"""OpenAI-compatible HTTP server.

Parity: reference zhilight/server/openai/entrypoints/api_server.py (FastAPI
/health /v1/models /version /v1/chat/completions /v1/completions + SSE
streaming + Prometheus /metrics + --api-key auth + multi-node worker no-op
mode) and cli args (engine/arg_utils.py:39-131, entrypoints/cli_args.py).

This build uses **aiohttp** (fastapi/uvicorn are not in the base image) — the
HTTP surface and JSON bodies are identical to the reference's. It serves the
port's engine (``zhilight_tpu_torch``) on the GPU unless ``--device`` names
another device; without one and without a GPU it raises, as ``LLM`` does.
Tensor parallelism runs one process a rank under torchrun: rank 0 serves
HTTP, the other ranks serve none and run the scheduler in lockstep. Without
such a launch ``--tensor-parallel N`` raises. Data and pipeline parallelism
and multi-host serving are not ported yet: their flags raise. Embeddings
(``/v1/embeddings``) answer 501 under tensor parallelism: they run outside
the scheduler loop, on rank 0 alone.

Launch:
  python -m zhilight_tpu_torch.server.openai.api_server --model-path M [--port 8080]
      [--device cpu] [--max-model-len L] [--api-key K] [--environ K=V]
  torchrun --nproc-per-node 2 -m zhilight_tpu_torch.server.openai.api_server \
      --model-path M --tensor-parallel 2
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys
import time
from typing import Optional

from aiohttp import web

from ... import __version__
from ...config import (
    CacheConfig,
    EngineConfig,
    ParallelConfig,
    SchedulerConfig,
)
from ...engine.generator import DynamicBatchGenerator
from ...parallel.comm import leave, require_launch
from .metrics import ServingMetrics
from .protocol import (
    ChatCompletionRequest,
    EmbeddingData,
    EmbeddingRequest,
    EmbeddingResponse,
    ChatCompletionResponse,
    ChatCompletionChoice,
    ChatCompletionStreamChoice,
    ChatCompletionStreamResponse,
    ChatMessage,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    DeltaMessage,
    ErrorResponse,
    ModelCard,
    ModelList,
    UsageInfo,
)
from .reasoning import ReasoningParser
from .serving import AsyncEngine, arg_from_request

logger = logging.getLogger(__name__)

__all__ = ["build_app", "main"]


def _choice_logprobs(tokenizer, out):
    """OpenAI-format per-token logprobs from the engine's device-sampled
    chosen/top logprobs."""
    from .protocol import ChoiceLogProbs, LogProbEntry

    if not out.logprobs and not out.top_logprobs:
        return None
    entries = []
    for i, tid in enumerate(out.token_ids):
        tok = tokenizer.decode([tid])
        lp = (
            out.logprobs[i]
            if out.logprobs and i < len(out.logprobs)
            else 0.0
        )
        tops = (
            out.top_logprobs[i]
            if out.top_logprobs and i < len(out.top_logprobs)
            else {}
        )
        entries.append(
            LogProbEntry(
                token=tok,
                logprob=float(lp),
                bytes=list(tok.encode("utf-8", errors="replace")),
                top_logprobs=[
                    {"token": tokenizer.decode([t]), "logprob": float(v)}
                    for t, v in tops.items()
                ],
            )
        )
    return ChoiceLogProbs(content=entries)


async def _generate_n(engine, tokens, arg, n: int, best_of: Optional[int] = None):
    """n independent samples for one prompt (OpenAI ``n``/``best_of``;
    reference maps them through its vLLM-derived SamplingParams): concurrent
    tasks with distinct seeds so the continuous-batching scheduler packs
    them together; with best_of > n the top n by cumulative logprob return."""
    m = max(best_of or n, n)
    if m == 1:
        return [await engine.generate(tokens, arg)]
    import dataclasses

    base_seed = arg.seed or 42
    args = [dataclasses.replace(arg, seed=base_seed + i) for i in range(m)]
    outs = list(
        await asyncio.gather(*(engine.generate(tokens, a) for a in args))
    )
    if m > n:
        outs = sorted(outs, key=lambda o: -o.score)[:n]
    return outs


def _error(status: int, message: str) -> web.Response:
    return web.json_response(
        ErrorResponse(message=message, code=status).model_dump(), status=status
    )


def build_app(engine: AsyncEngine, served_model: str, api_key: Optional[str] = None,
              enable_reasoning: bool = False) -> web.Application:
    metrics = ServingMetrics()
    app = web.Application()

    @web.middleware
    async def auth_mw(request: web.Request, handler):
        if api_key and request.path.startswith("/v1"):
            auth = request.headers.get("Authorization", "")
            if auth != f"Bearer {api_key}":
                return _error(401, "invalid api key")
        return await handler(request)

    app.middlewares.append(auth_mw)

    async def health(_):
        if engine.dead:
            return _error(500, "engine dead")
        return web.Response(text="")

    async def version(_):
        return web.json_response({"version": __version__})

    async def models(_):
        return web.json_response(
            ModelList(data=[ModelCard(id=served_model)]).model_dump()
        )

    async def prom_metrics(_):
        metrics.observe_queue(**engine.stats())
        return web.Response(body=metrics.render(), content_type="text/plain")

    async def options(_):
        return web.json_response(engine.stats())

    # -- chat completions ----------------------------------------------
    async def chat_completions(request: web.Request):
        try:
            req = ChatCompletionRequest(**await request.json())
        except Exception as e:
            return _error(400, f"bad request: {e}")
        try:
            tokens = engine.encode_chat(req)
        except Exception as e:
            return _error(400, f"chat template error: {e}")
        if len(tokens) >= engine.max_model_len:
            return _error(400, "prompt too long")
        arg = arg_from_request(req, engine.max_model_len)
        n = max(req.n or 1, 1)
        if req.stream:
            return await _stream_chat(request, req, tokens, arg)

        outs = await _generate_n(engine, tokens, arg, n, req.best_of)
        choices = []
        completion_tokens = 0
        for i, out in enumerate(outs):
            parser = ReasoningParser(enabled=enable_reasoning)
            reasoning, content = parser.feed(out.text)
            r2, c2 = parser.flush()
            reasoning += r2
            content += c2
            choices.append(
                ChatCompletionChoice(
                    index=i,
                    message=ChatMessage(
                        role="assistant",
                        content=content,
                        reasoning_content=reasoning or None,
                    ),
                    logprobs=(
                        _choice_logprobs(engine.tokenizer, out)
                        if req.logprobs
                        else None
                    ),
                    finish_reason=out.finish_reason,
                )
            )
            completion_tokens += out.output_tokens_num
            metrics.observe_request(len(tokens), out)
        resp = ChatCompletionResponse(
            model=req.model or served_model,
            choices=choices,
            usage=UsageInfo(
                prompt_tokens=len(tokens),
                completion_tokens=completion_tokens,
                total_tokens=len(tokens) + completion_tokens,
            ),
        )
        return web.json_response(resp.model_dump(exclude_none=True))

    async def _stream_chat(request, req, tokens, arg):
        n = max(req.n or 1, 1)
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
        )
        await resp.prepare(request)
        parsers = [ReasoningParser(enabled=enable_reasoning) for _ in range(n)]

        async def send(chunk: ChatCompletionStreamResponse):
            await resp.write(
                f"data: {json.dumps(chunk.model_dump(exclude_none=True))}\n\n".encode()
            )

        first = ChatCompletionStreamResponse(
            model=req.model or served_model,
            choices=[
                ChatCompletionStreamChoice(index=i, delta=DeltaMessage(role="assistant"))
                for i in range(n)
            ],
        )
        rid = first.id
        await send(first)

        import dataclasses

        base_seed = arg.seed or 42
        args = (
            [arg]
            if n == 1
            else [dataclasses.replace(arg, seed=base_seed + i) for i in range(n)]
        )
        q: asyncio.Queue = asyncio.Queue()

        async def drive(i, a):
            try:
                async for text, out in engine.generate_stream(tokens, a):
                    await q.put((i, text, out, None))
            except BaseException as e:  # surfaced on the main loop
                await q.put((i, "", None, e))

        drivers = [asyncio.create_task(drive(i, a)) for i, a in enumerate(args)]
        finals = {}
        emitted = set()  # choice indices that have sent at least one delta
        try:
            while len(finals) < n:
                i, text, out, err = await q.get()
                if err is not None:
                    raise err
                if out is not None:
                    finals[i] = out
                    reasoning, content = parsers[i].flush()
                    last = len(finals) == n
                    total = sum(o.output_tokens_num for o in finals.values())
                    await send(ChatCompletionStreamResponse(
                        id=rid,
                        model=req.model or served_model,
                        choices=[
                            ChatCompletionStreamChoice(
                                index=i,
                                delta=DeltaMessage(
                                    content=content or None,
                                    reasoning_content=reasoning or None,
                                ),
                                finish_reason=out.finish_reason,
                            )
                        ],
                        usage=UsageInfo(
                            prompt_tokens=len(tokens),
                            completion_tokens=total,
                            total_tokens=len(tokens) + total,
                        ) if last else None,
                    ))
                    metrics.observe_request(len(tokens), out)
                else:
                    reasoning, content = parsers[i].feed(text)
                    # forward the engine's first-chunk TTFT signal even when
                    # the detokenizer/parser holds back all text (partial
                    # UTF-8, open <think> tag): clients measure TTFT by the
                    # first SSE chunk, so choice i's first step payload always
                    # emits one (possibly empty) delta. /v1/completions does
                    # the same in _stream_completion.
                    if reasoning or content or i not in emitted:
                        emitted.add(i)
                        await send(ChatCompletionStreamResponse(
                            id=rid,
                            model=req.model or served_model,
                            choices=[
                                ChatCompletionStreamChoice(
                                    index=i,
                                    delta=DeltaMessage(
                                        content=content or None,
                                        reasoning_content=reasoning or None,
                                    ),
                                )
                            ],
                        ))
        finally:
            for d in drivers:
                d.cancel()
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    # -- completions ----------------------------------------------------
    async def completions(request: web.Request):
        try:
            req = CompletionRequest(**await request.json())
        except Exception as e:
            return _error(400, f"bad request: {e}")
        prompts = req.prompt if isinstance(req.prompt, list) and req.prompt and isinstance(req.prompt[0], (list, str)) else [req.prompt]
        arg0 = arg_from_request(req, engine.max_model_len)
        if req.stream:
            if len(prompts) != 1:
                return _error(400, "streaming supports a single prompt")
            return await _stream_completion(request, req, engine.encode_prompt(prompts[0]), arg0)
        choices = []
        usage = UsageInfo()
        n = max(req.n or 1, 1)
        idx = 0
        for p in prompts:
            tokens = engine.encode_prompt(p)
            if len(tokens) >= engine.max_model_len:
                return _error(400, "prompt too long")
            outs = await _generate_n(engine, tokens, arg0, n, req.best_of)
            for out in outs:
                text = out.text
                if req.echo and isinstance(p, str):
                    text = p + text
                choices.append(
                    CompletionChoice(
                        index=idx,
                        text=text,
                        logprobs=(
                            _choice_logprobs(engine.tokenizer, out)
                            if req.logprobs
                            else None
                        ),
                        finish_reason=out.finish_reason,
                    )
                )
                idx += 1
                usage.completion_tokens += out.output_tokens_num
                metrics.observe_request(len(tokens), out)
            usage.prompt_tokens += len(tokens)
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        resp = CompletionResponse(model=req.model or served_model, choices=choices, usage=usage)
        return web.json_response(resp.model_dump(exclude_none=True))

    async def _stream_completion(request, req, tokens, arg):
        n = max(req.n or 1, 1)
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)

        import dataclasses

        base_seed = arg.seed or 42
        args = (
            [arg]
            if n == 1
            else [dataclasses.replace(arg, seed=base_seed + i) for i in range(n)]
        )
        q: asyncio.Queue = asyncio.Queue()

        async def drive(i, a):
            try:
                async for text, out in engine.generate_stream(tokens, a):
                    await q.put((i, text, out, None))
            except BaseException as e:
                await q.put((i, "", None, e))

        drivers = [asyncio.create_task(drive(i, a)) for i, a in enumerate(args)]
        cid = None
        finals = {}
        try:
            while len(finals) < n:
                i, text, out, err = await q.get()
                if err is not None:
                    raise err
                if out is not None:
                    finals[i] = out
                    metrics.observe_request(len(tokens), out)
                    continue
                chunk = CompletionResponse(
                    model=req.model or served_model,
                    choices=[CompletionChoice(index=i, text=text)],
                )
                chunk.object = "text_completion"
                if cid is None:
                    cid = chunk.id
                chunk.id = cid
                await resp.write(
                    f"data: {json.dumps(chunk.model_dump(exclude_none=True))}\n\n".encode()
                )
        finally:
            for d in drivers:
                d.cancel()
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    app.router.add_get("/health", health)
    app.router.add_get("/version", version)
    app.router.add_get("/v1/models", models)
    app.router.add_get("/metrics", prom_metrics)
    app.router.add_get("/v1/options", options)
    # -- embeddings (beyond reference parity: mean-pooled last hidden) --
    async def embeddings(request: web.Request):
        if getattr(engine.llm, "tp_group", None) is not None:
            return _error(501, "embeddings are not served under tensor parallelism")
        try:
            req = EmbeddingRequest(**await request.json())
        except Exception as e:
            return _error(400, f"bad request: {e}")
        raw = req.input
        if isinstance(raw, str) or (raw and isinstance(raw[0], int)):
            items = [raw]
        else:
            items = list(raw)
        loop = asyncio.get_running_loop()
        data = []
        usage = UsageInfo()
        for i, item in enumerate(items):
            tokens = engine.encode_prompt(item)
            if len(tokens) >= engine.max_model_len:
                return _error(400, "input too long")
            hs = await loop.run_in_executor(
                None, engine.llm.executor.run_hidden, __import__("numpy").asarray(tokens, dtype="int32")
            )
            emb = hs.astype("float32").mean(axis=0)
            data.append(EmbeddingData(index=i, embedding=[float(x) for x in emb]))
            usage.prompt_tokens += len(tokens)
        usage.total_tokens = usage.prompt_tokens
        resp = EmbeddingResponse(
            model=req.model or served_model, data=data, usage=usage
        )
        return web.json_response(resp.model_dump())

    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/embeddings", embeddings)
    return app


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    p = argparse.ArgumentParser("zhilight_tpu_torch OpenAI server")
    p.add_argument("--model-path", required=True)
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: the GPU; 'cpu' runs on the CPU)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--api-key", default=None)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--tensor-parallel", "-tp", type=int, default=1)
    p.add_argument("--data-parallel", "-dp", type=int, default=1)
    p.add_argument("--pipeline-parallel", "-pp", type=int, default=1)
    p.add_argument("--dyn-max-batch-size", type=int, default=32)
    p.add_argument("--max-total-token", type=int, default=32768)
    p.add_argument("--chunk-size", type=int, default=512)
    p.add_argument("--enable-prefix-caching", action="store_true")
    p.add_argument("--enable-reasoning", action="store_true")
    p.add_argument("--ignore-eos", action="store_true")
    p.add_argument("--kv-dtype", default="bfloat16", choices=["bfloat16", "int8"])
    p.add_argument(
        "--no-warmup",
        action="store_true",
        help="skip the startup compile/self-test pass (reference VERIFY_MAX_TOKEN)",
    )
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--dist-init-addr", default=None)
    p.add_argument(
        "--environ",
        action="append",
        default=[],
        help="KEY=VAL set before engine init (reference preparse_cli_args)",
    )
    return p.parse_args(argv)


def make_engine_config(args) -> EngineConfig:
    if args.data_parallel * args.pipeline_parallel > 1:
        raise NotImplementedError("data and pipeline parallelism are not ported yet")
    if args.tensor_parallel > 1:
        require_launch(args.tensor_parallel)
    if args.nnodes > 1 or args.node_rank > 0:
        raise NotImplementedError("multi-host serving is not ported yet")
    return EngineConfig(
        model_path=args.model_path,
        max_model_len=args.max_model_len,
        cache=CacheConfig(
            kv_dtype=args.kv_dtype,
            enable_prefix_caching=args.enable_prefix_caching,
        ),
        scheduler=SchedulerConfig(
            max_batch=args.dyn_max_batch_size,
            max_total_token=args.max_total_token,
            chunk_size=args.chunk_size,
            ignore_eos=args.ignore_eos,
        ),
        parallel=ParallelConfig(
            tp=args.tensor_parallel,
            dp=args.data_parallel,
            pp=args.pipeline_parallel,
            num_hosts=args.nnodes,
            host_rank=args.node_rank,
            coordinator_address=args.dist_init_addr,
        ),
    )


def main(argv=None):
    args = parse_args(argv)
    for kv in args.environ:
        k, _, v = kv.partition("=")
        os.environ[k] = v
    logging.basicConfig(level=logging.INFO)

    from ...llm import LLM

    llm = LLM(model_path=args.model_path, engine_config=make_engine_config(args),
              device=args.device)
    if not args.no_warmup:
        # a chunk of every prefill bucket, a packed group and a decode window
        # at serving shapes before accepting traffic (reference
        # VERIFY_MAX_TOKEN, zhilight/dynamic_batch.py:415-422): an
        # out-of-memory or a kernel fault surfaces here
        logger.info("warmup: serving-shape self-test...")
        dt = llm.executor.warmup()
        logger.info("warmup done in %.1fs", dt)
    gen = DynamicBatchGenerator(llm).start()
    if llm.tp_group is not None and llm.tp_group.rank > 0:
        # tensor-parallel ranks above 0 serve no HTTP (the reference's worker
        # nodes, api_server.py:549-554): their scheduler thread replays rank
        # 0's loop in lockstep, entering the same collectives, and exits when
        # rank 0 shuts down
        logger.info("tensor-parallel rank %d: serving no HTTP, running the lockstep scheduler",
                    llm.tp_group.rank)
        gen.scheduler._thread.join()
        leave()
        if gen.scheduler.error is not None:
            raise RuntimeError("the lockstep scheduler failed") from gen.scheduler.error
        return
    engine = AsyncEngine(llm, gen)
    served = args.served_model_name or os.path.basename(args.model_path.rstrip("/"))

    app = build_app(engine, served, api_key=args.api_key, enable_reasoning=args.enable_reasoning)
    try:
        web.run_app(app, host=args.host, port=args.port)
    finally:
        gen.stop()
        if llm.tp_group is not None:
            leave()


if __name__ == "__main__":
    main()
