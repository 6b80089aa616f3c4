"""Registry-extension families that bring their own init (C3), on the CPU.

A family whose config sets ``custom_init`` supplies its params through its
own ``init_params``, in JAX (``engine/weights.py`` ``load_or_init_params``)
and in the port. The config here carries only what JAX's scripted families
of ``tests/test_product_path_engine.py`` carry: none of Qwen3's fields
(``hidden``, ``dtype``, ``int8_weights``, ``fused_decode_fits``). Its
forward replays a token script (greedy decode at absolute position ``p``
emits ``script[p + 1]``), so both engines must give the same greedy streams
token for token. Also: ``load_or_init_params`` calls the family's init, the
engine refuses int8 for such a family as for the MoE families, and the
built-in families' random params do not depend on the registry's new
field.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import weights as tweights
from deepsearch_tts_tpu_torch.models import registry as tregistry

torch.set_num_threads(1)

NAME = "script-torch-parity"
TOK = ByteTokenizer()
SCRIPT_LEN = 640
ENGINE_KW = dict(max_slots=4, page_size=16, n_pages=129, max_seq_len=512,
                 decode_chunk_len=4, seed=0)


def _script(seed: int = 0) -> np.ndarray:
    """A token script over the byte vocabulary with the EOS planted once,
    at position 300, so one stream stops on it."""
    s = np.random.default_rng(seed).integers(0, 256, SCRIPT_LEN).astype(np.int32)
    s[300] = TOK.eos_id
    return s


class _JaxScriptCfg:
    vocab_size = TOK.vocab_size
    n_layers = 1
    n_kv_heads = 1
    head_dim = 8
    jnp_dtype = jnp.float32
    custom_init = True


class _TorchScriptCfg:
    vocab_size = TOK.vocab_size
    n_layers = 1
    n_kv_heads = 1
    head_dim = 8
    torch_dtype = torch.float32
    custom_init = True


def _jax_forward(params, cfg, tokens, positions, *, k_pages=None, v_pages=None,
                 logits_indices=None, **kw):
    script = params["script"]
    pos = positions
    if logits_indices is not None:
        pos = jnp.take_along_axis(positions, logits_indices[:, None], axis=1)
    nxt = script[jnp.clip(pos + 1, 0, script.shape[0] - 1)]
    return 30.0 * jax.nn.one_hot(nxt, cfg.vocab_size, dtype=jnp.float32), (k_pages, v_pages)


def _torch_forward(params, cfg, tokens, positions, *, k_pages=None, v_pages=None,
                   logits_indices=None, **kw):
    script = params["script"]
    pos = positions
    if logits_indices is not None:
        pos = torch.gather(positions, 1, logits_indices[:, None])
    nxt = script[torch.clamp(pos + 1, 0, script.shape[0] - 1)]
    logits = 30.0 * torch.nn.functional.one_hot(nxt, cfg.vocab_size).to(torch.float32)
    return logits, (k_pages, v_pages)


INIT_CALLS: list = []


def _torch_init(cfg, *, seed, device):
    INIT_CALLS.append((cfg, seed, device))
    return {"script": torch.from_numpy(_script(seed)).long().to(device)}


def _register():
    jregistry.register(NAME, _JaxScriptCfg(),
                       lambda cfg, key: {"script": jnp.asarray(_script(0))},
                       _jax_forward, lambda: {})
    tregistry.register(NAME, _TorchScriptCfg(), _torch_forward, init_params=_torch_init)


def _greedy(ids, n):
    return dict(prompt_ids=list(ids), max_tokens=n, temperature=0.0, top_k=0, top_p=1.0,
                min_p=0.0, repetition_penalty=1.0)


@pytest.fixture(scope="module")
def engines():
    _register()
    je = jengine.Engine(NAME, TOK, prefill_lane=0, **ENGINE_KW)
    te = tengine.Engine(NAME, TOK, device="cpu", **ENGINE_KW)
    yield je, te
    je.shutdown()
    te.shutdown()


def _both(engines, reqs):
    out = []
    for mod, eng in zip((jengine, tengine), engines):
        futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
        out.append([f.result(timeout=300) for f in futs])
    return out


def test_scripted_family_streams_match_jax(engines):
    """Three concurrent prompts, then a follow-up that re-enters a cached
    prefix; one stream runs into the planted EOS at position 300."""
    je, te = engines
    assert not te.layer_fusion and te.cfg.custom_init
    assert te.k_pages.dtype == torch.float32
    rng = np.random.default_rng(1)
    reqs = [_greedy(rng.integers(0, 256, n), m) for n, m in ((9, 24), (40, 16), (290, 40))]
    jres, tres = _both(engines, reqs)
    script = _script(0)
    for r, j, t in zip(reqs, jres, tres):
        n = len(r["prompt_ids"])
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.prompt_tokens, t.completion_tokens) == (
            j.finish_reason, j.prompt_tokens, j.completion_tokens)
        # the script itself: position n - 1 emits script[n], and so on
        want = list(script[n:n + len(t.token_ids)])
        assert t.token_ids == want
    # (the EOS ends the stream and is not part of it)
    assert tres[2].finish_reason == "stop" and len(tres[2].token_ids) == 300 - 290
    assert tres[0].finish_reason == "length" and len(tres[0].token_ids) == 24
    follow = reqs[0]["prompt_ids"] + tres[0].token_ids + list(rng.integers(0, 256, 5))
    jres, tres = _both(engines, [_greedy(follow, 12)])
    assert tres[0].token_ids == jres[0].token_ids
    assert tres[0].cached_prompt_tokens == jres[0].cached_prompt_tokens > 0


def test_load_or_init_params_calls_the_family_init():
    _register()
    INIT_CALLS.clear()
    params, name = tweights.load_or_init_params(NAME, seed=3, device="cpu")
    assert name == NAME and len(INIT_CALLS) == 1
    cfg, seed, device = INIT_CALLS[0]
    assert isinstance(cfg, _TorchScriptCfg) and seed == 3 and device == torch.device("cpu")
    assert torch.equal(params["script"], torch.from_numpy(_script(3)).long())
    # the engine's params=None branch takes the same init
    INIT_CALLS.clear()
    eng = tengine.Engine(NAME, TOK, device="cpu", **{**ENGINE_KW, "seed": 5})
    assert len(INIT_CALLS) == 1 and INIT_CALLS[0][1] == 5
    assert torch.equal(eng.params["script"], torch.from_numpy(_script(5)).long())


def test_custom_init_family_refuses_int8():
    """No int8 for a config without the int8 fields: the errors the MoE
    families give."""
    _register()
    with pytest.raises(NotImplementedError, match="int8"):
        tengine.Engine(NAME, TOK, device="cpu", quantize="int8", **ENGINE_KW)
    with pytest.raises(ValueError, match="int8 KV"):
        tengine.Engine(NAME, TOK, device="cpu", kv_quantize="int8", **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="int8"):
        tweights.load_or_init_params(NAME, device="cpu", quantize="int8")


def test_custom_init_without_init_params_raises():
    tregistry.register(NAME + "-no-init", _TorchScriptCfg(), _torch_forward)
    with pytest.raises(ValueError, match="without init_params"):
        tweights.load_or_init_params(NAME + "-no-init", device="cpu")


@pytest.mark.parametrize("model", ["qwen3-test", "qwen3-moe-test", "deepseek-v3-test"])
def test_builtin_families_keep_random_params(model):
    """Built-in families set no custom_init and carry no init_params: they
    take random_params as before, and the engine's params=None branch
    packs the same tree."""
    fam = tregistry.get_model(model)
    assert fam.init_params is None and not getattr(fam.config, "custom_init", False)
    got, name = tweights.load_or_init_params(model, seed=7, device="cpu")
    want = tweights.random_params(fam.config, device="cpu", seed=7)
    assert name == model
    flat_got, flat_want = _flatten(got), _flatten(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        assert torch.equal(flat_got[k], flat_want[k]), k
    eng = tengine.Engine(model, TOK, device="cpu", max_slots=2, page_size=8, n_pages=16,
                         max_seq_len=64, seed=7)
    packed = _flatten(tweights.pack_matmul_params(want))
    served = _flatten(eng.params)
    assert served.keys() == packed.keys()
    for k in packed:
        assert torch.equal(served[k], packed[k]), k


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
