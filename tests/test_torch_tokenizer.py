"""The port's ``LLM`` with a tokenizer, against the JAX package's, on the CPU.

Both load the verify recipe's checkpoint (tools/make_tiny_model.py: a
byte-level BPE tokenizer with a chat template) by ``model_path``. String
prompts and chat messages through ``DynamicBatchGenerator`` give the JAX
engine's greedy tokens and text, in the dtype both packages serve the
checkpoint in (bf16: anything but float16 is served in bf16,
``config/adapters.py:63`` of each) and in float32, the dtype it declares; in
float32 the scoring utilities on a string give the JAX ``LLM``'s logits to
1e-4. The EOS
sets are equal, the tokenizer's id first. A directory without tokenizer files
raises the reference's ``ValueError`` on a string; one whose tokenizer cannot
load because ``transformers`` does not import serves token ids and raises an
``ImportError`` naming it on every string and at the server's start.
"""

import dataclasses
import importlib.util
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from zhilight_tpu.config import load_model_config as j_load_model_config
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu_torch.config import load_model_config as t_load_model_config
from zhilight_tpu_torch.engine import DynamicBatchGenerator as TGenerator
from zhilight_tpu_torch.engine import GeneratorArg as TGeneratorArg
from zhilight_tpu_torch.llm import LLM as TLLM

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
PROMPTS = ["hello world how are", "the quick brown fox jumps"]
CHAT = [{"role": "user", "content": "the lazy dog"}, {"role": "assistant", "content": "hello"},
        {"role": "user", "content": "how are you"}]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("make_tiny_model",
                                                  ROOT / "tools" / "make_tiny_model.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    path = str(tmp_path_factory.mktemp("tiny-llama"))
    maker.make(path)
    return path


def _pair(tiny, dtype=None):
    tcfg, jcfg = t_load_model_config(tiny)[0], j_load_model_config(tiny)[0]
    if dtype:
        tcfg, jcfg = dataclasses.replace(tcfg, dtype=dtype), dataclasses.replace(jcfg, dtype=dtype)
    return (TLLM(model_path=tiny, model_config=tcfg, device="cpu"),
            JLLM(model_path=tiny, model_config=jcfg))


@pytest.fixture(scope="module")
def checkpoint_dtype(tiny):
    return _pair(tiny)


@pytest.fixture(scope="module")
def float32(tiny):
    return _pair(tiny, "float32")


@pytest.fixture(params=["checkpoint_dtype", "float32"])
def pair(request):
    return request.getfixturevalue(request.param)


def _serve(llm, gen_cls, arg_cls, prompts):
    with gen_cls(llm) as gen:
        return [(o.token_ids, o.text, o.finish_reason)
                for r in gen.batch_generate(prompts, arg_cls(max_length=10)) for o in r.outputs]


def test_tokenizer_loads_and_eos_sets_agree(pair):
    tllm, jllm = pair
    assert type(tllm.tokenizer).__name__ == type(jllm.tokenizer).__name__
    assert tllm.tokenizer.encode(PROMPTS[0]) == jllm.tokenizer.encode(PROMPTS[0])
    t_s, j_s = tllm.engine_config.scheduler, jllm.engine_config.scheduler
    assert (t_s.eos_id, t_s.eos_ids) == (j_s.eos_id, j_s.eos_ids)
    assert t_s.eos_ids[0] == tllm.tokenizer.eos_token_id


def test_string_prompts_give_the_jax_tokens(pair):
    tllm, jllm = pair
    got = _serve(tllm, TGenerator, TGeneratorArg, PROMPTS)
    want = _serve(jllm, JGenerator, JGeneratorArg, PROMPTS)
    assert got == want and all(len(t) > 0 for t, _, _ in got)


def test_chat_messages_give_the_jax_tokens(pair):
    tllm, jllm = pair
    got = _serve(tllm, TGenerator, TGeneratorArg, [CHAT])
    want = _serve(jllm, JGenerator, JGeneratorArg, [CHAT])
    assert got == want


@pytest.mark.parametrize("fn", ["calc_logits", "calc_hidden_states"])
def test_string_scoring_matches_jax(float32, fn):
    tllm, jllm = float32
    got, want = getattr(tllm, fn)(PROMPTS[1]), getattr(jllm, fn)(PROMPTS[1])
    assert got.shape == want.shape == (len(tllm.tokenizer.encode(PROMPTS[1])), got.shape[1])
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got, getattr(tllm, fn)(tllm.tokenizer.encode(PROMPTS[1])))


def test_string_log_prob_loss_and_greedy_match_match_jax(float32):
    tllm, jllm = float32
    (t_total, t_per), (j_total, j_per) = (tllm.calc_log_prob(PROMPTS[0]),
                                          jllm.calc_log_prob(PROMPTS[0]))
    np.testing.assert_allclose(t_per, j_per, atol=TOL, rtol=TOL)
    assert abs(t_total - j_total) < TOL * max(1.0, abs(j_total))
    assert abs(tllm.calc_loss(PROMPTS[0]) - jllm.calc_loss(PROMPTS[0])) < TOL
    assert tllm.calc_greedy_match(PROMPTS[0]) == jllm.calc_greedy_match(PROMPTS[0])


def _weights_only(tiny, dst):
    """The checkpoint without its tokenizer files."""
    for name in ("config.json", "generation_config.json", "model.safetensors"):
        shutil.copy(Path(tiny) / name, dst / name)
    return str(dst)


def test_directory_without_tokenizer_raises_on_a_string(tiny, tmp_path):
    llm = TLLM(model_path=_weights_only(tiny, tmp_path), device="cpu")
    assert llm.tokenizer is None and llm.tokenizer_error is None
    with pytest.raises(ValueError, match="no tokenizer for string input"):
        llm.calc_logits("hello")
    assert llm.calc_logits([5, 6, 7]).shape[0] == 3


def test_missing_transformers_serves_ids_and_raises_on_strings(tiny, monkeypatch):
    from zhilight_tpu_torch.server.openai.serving import AsyncEngine

    monkeypatch.setitem(sys.modules, "transformers", None)  # import transformers fails
    llm = TLLM(model_path=tiny, device="cpu")
    assert llm.tokenizer is None and isinstance(llm.tokenizer_error, ImportError)
    with pytest.raises(ImportError, match="transformers"):
        llm.calc_logits("hello")
    with TGenerator(llm) as gen:
        with pytest.raises(ImportError, match="transformers"):
            gen.generate("hello", TGeneratorArg(max_length=4))
        with pytest.raises(ImportError, match="transformers"):
            AsyncEngine(llm, gen)
        out = gen.generate([5, 6, 7], TGeneratorArg(max_length=4)).outputs[0]
    assert len(out.token_ids) > 0
