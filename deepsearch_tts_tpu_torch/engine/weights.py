"""Weights: HF safetensors → the stacked-layer param tree (port of
``engine/weights.py``: dense Qwen3, Qwen3-MoE, and DeepSeek-V3 / Kimi-K2,
whose MLA tree has two stacks, ``dense_layers`` and ``moe_layers``, and is
served unpacked).

The tree has the JAX package's layout (right-multiply weights, per-layer
tensors stacked on a leading layer axis; MoE expert stacks [L,NE,...]) so
that params convert leaf by leaf in both directions. Random init, used when
no checkpoint is given, is drawn on the target device from a seeded
``torch.Generator``, directly in the packed single-device layout.

Both random init and the checkpoint converters write the packed layout
the engine serves (``wqkv``, ``w_gateup``), one layer matrix at a time.
``quantize="int8"`` (random init and the dense and Qwen3-MoE converters):
every matrix named in ``ops/quant.QUANT_KEYS`` is drawn or read one layer
(or expert) matrix at a time, packed, and quantized by B12 (round to
nearest, per column) into a preallocated int8 stack with its float32
scales, so the bf16 tree of a large model never exists whole beside its
int8 copy (qwen3-32b: 65.6 GB in bf16, 33.6 GB int8). Per-column scales
make this equal to ``quantize_params`` of the whole bf16 tree, bit for bit.
The MLA family takes no int8 weights (:data:`INT8_MLA_REFUSED`).

The safetensors reader has a writer beside it (:func:`save_safetensors`),
which ``train/checkpoint.py`` saves param and LoRA trees with; the reader's
``tensor`` returns a tensor as stored (bf16 bit for bit) and keeps the
header's ``__metadata__``. :func:`unpack_matmul_params` inverts the
packing (column views), as the hot-load of a LoRA adapter reads it.
"""
from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping

import numpy as np
import torch


_DTYPES = {
    "F32": np.float32, "F16": np.float16, "BF16": np.uint16,  # bf16 via view
    "I64": np.int64, "I32": np.int32, "U8": np.uint8,
    "F64": np.float64, "I16": np.int16, "I8": np.int8, "BOOL": np.bool_,
}
# torch dtype ↔ safetensors dtype name (the writer's, and the reader's
# ``tensor``: bf16 is stored as its 16 bits)
_ST_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64", torch.int32: "I32", torch.uint8: "U8",
             torch.float64: "F64", torch.int16: "I16", torch.int8: "I8",
             torch.bool: "BOOL"}
_ST_TORCH = {v: k for k, v in _ST_NAMES.items()}


class _Checkpoint(Mapping):
    """name → ndarray over a safetensors directory, each tensor read from
    its file when it is looked up (bf16 widened to float32 by bit shift),
    so the host never holds a whole checkpoint in float32 — a qwen3-30b-a3b
    checkpoint would take 122 GB."""

    def __init__(self, index: dict, metadata: dict | None = None):
        self._index = index
        self.metadata = metadata or {}   # the files' ``__metadata__`` (str → str)

    def _raw(self, name: str) -> np.ndarray:
        fname, base, meta = self._index[name]
        start, end = meta["data_offsets"]
        dt = _DTYPES[meta["dtype"]]
        return np.fromfile(fname, dtype=dt, count=(end - start) // np.dtype(dt).itemsize,
                           offset=base + start).reshape(meta["shape"])

    def __getitem__(self, name: str) -> np.ndarray:
        arr = self._raw(name)
        if self._index[name][2]["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor as stored, dtype included (bf16 bit for bit), on the
        CPU."""
        st = self._index[name][2]["dtype"]
        arr = self._raw(name)
        if st == "BF16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr).to(_ST_TORCH[st])

    def __iter__(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)


def _load_safetensors_dir(path: str) -> _Checkpoint:
    """Minimal safetensors reader (little-endian header length, JSON header,
    raw tensor bytes), numpy only: reads the headers now and each tensor
    when it is looked up."""
    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    index, metadata = {}, {}
    for fname in sorted(files):
        full = os.path.join(path, fname)
        with open(full, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
        for name, meta in header.items():
            if name == "__metadata__":
                metadata.update(meta)
            else:
                index[name] = (full, 8 + hlen, meta)
    return _Checkpoint(index, metadata)


def save_safetensors(path: str, tensors: dict, metadata: dict | None = None) -> None:
    """Write ``tensors`` (name → tensor, any device) and ``metadata`` (str →
    str, the header's ``__metadata__``) as one safetensors file: the 8-byte
    little-endian header length, the JSON header padded with spaces to a
    multiple of 8, then each tensor's bytes in order (bf16 bit for bit).
    :func:`_load_safetensors_dir` reads it back."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    off = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            f.write(host.numpy().reshape(-1).view(np.uint8))


def _to_torch(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


class _Stack:
    """A [*lead, K, N] weight stack filled one [K, N] matrix (or a column
    block of one) at a time: plain in ``dtype``, or int8 ``{q, scales}``
    with ``quantize="int8"``, each matrix rounded to ``dtype`` first and then
    quantized by B12 once all its columns are in (the scratch holds one
    matrix)."""

    def __init__(self, shape, dtype, device, quantize: str | None):
        self.dtype, self.quantize = dtype, quantize
        if quantize is None:
            self.out = torch.empty(shape, dtype=dtype, device=device)
            return
        if quantize != "int8":
            raise ValueError(f"unknown quantize {quantize!r} (None or 'int8')")
        K, N = shape[-2:]
        self.q = torch.empty(shape, dtype=torch.int8, device=device)
        self.s = torch.empty(tuple(shape[:-2]) + (1, N), dtype=torch.float32, device=device)
        self.scratch = torch.empty((K, N), dtype=dtype, device=device)
        self.out = {"q": self.q, "scales": self.s}

    def set(self, idx: tuple, cols: slice, mat: torch.Tensor, last: bool = True) -> None:
        """Columns ``cols`` of matrix ``idx``; ``last``: its final block."""
        if self.quantize is None:
            self.out[idx][..., cols].copy_(mat)
            return
        from ..ops.quant import quantize_int8

        self.scratch[:, cols].copy_(mat)
        if last:
            quantize_int8(self.scratch, out=(self.q[idx], self.s[idx]))


def _layer_stack(raw, L: int, fmt: str, dt, device, transpose=True) -> torch.Tensor:
    mats = [raw[fmt.format(i)] for i in range(L)]
    return _to_torch(np.stack([m.T if transpose else m for m in mats]), dt, device)


def _packed(raw: Mapping[str, np.ndarray], cfg, shape: tuple, parts: list, dt, device,
            quantize: str | None):
    """A [L, *shape] stack whose layer i holds the HF matrices ``parts``
    ((name format, column count) pairs, transposed to right-multiply) side
    by side: read, packed and, with ``quantize``, quantized one layer at a
    time."""
    st = _Stack((cfg.n_layers,) + shape, dt, device, quantize)
    for i in range(cfg.n_layers):
        c0 = 0
        for j, (fmt, n) in enumerate(parts):
            st.set((i,), slice(c0, c0 + n), _to_torch(raw[fmt.format(i)].T, dt, device),
                   last=j == len(parts) - 1)
            c0 += n
    return st.out


def _convert_attention(raw: Mapping[str, np.ndarray], cfg, device, dt,
                       quantize: str | None = None) -> dict:
    """Embedding, norms, the packed attention stacks (``wqkv``, ``wo``) and
    lm_head: what the dense and the MoE family share."""
    E, H, K, D = cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = "model.layers.{}.self_attn."

    def norms(fmt):
        return _layer_stack(raw, cfg.n_layers, fmt, dt, device, transpose=False)

    params = {
        "embed": _to_torch(raw["model.embed_tokens.weight"], dt, device),
        "final_norm": _to_torch(raw["model.norm.weight"], dt, device),
        "layers": {
            "ln1": norms("model.layers.{}.input_layernorm.weight"),
            "ln2": norms("model.layers.{}.post_attention_layernorm.weight"),
            "q_norm": norms(attn + "q_norm.weight"),
            "k_norm": norms(attn + "k_norm.weight"),
            "wqkv": _packed(raw, cfg, (E, (H + 2 * K) * D),
                            [(attn + "q_proj.weight", H * D), (attn + "k_proj.weight", K * D),
                             (attn + "v_proj.weight", K * D)], dt, device, quantize),
            "wo": _packed(raw, cfg, (H * D, E), [(attn + "o_proj.weight", E)],
                          dt, device, quantize),
        },
    }
    if "lm_head.weight" in raw and not cfg.tie_embeddings:
        head = _Stack((E, cfg.vocab_size), dt, device, quantize)
        head.set((), slice(None), _to_torch(raw["lm_head.weight"].T, dt, device))
        params["lm_head"] = head.out
    return params


def convert_qwen3_dense(raw: Mapping[str, np.ndarray], cfg, device="cpu",
                        dtype: torch.dtype | None = None,
                        quantize: str | None = None) -> dict:
    """HF Qwen3 checkpoint → stacked param tree (models/qwen3.py layout), in
    the packed layout the engine serves (``wqkv``, ``w_gateup``), each layer
    matrix read and packed on its own. ``quantize="int8"``: ``wqkv``,
    ``wo``, ``w_gateup``, ``w_down`` and an untied ``lm_head`` as ``{q,
    scales}``, each quantized as it is packed."""
    dt = dtype or cfg.torch_dtype
    E, Fi = cfg.hidden, cfg.intermediate
    mlp = "model.layers.{}.mlp."
    params = _convert_attention(raw, cfg, device, dt, quantize)
    params["layers"]["w_gateup"] = _packed(
        raw, cfg, (E, 2 * Fi), [(mlp + "gate_proj.weight", Fi), (mlp + "up_proj.weight", Fi)],
        dt, device, quantize)
    params["layers"]["w_down"] = _packed(raw, cfg, (Fi, E), [(mlp + "down_proj.weight", E)],
                                         dt, device, quantize)
    return params


def convert_qwen3_moe(raw: Mapping[str, np.ndarray], cfg, device="cpu",
                      dtype: torch.dtype | None = None,
                      quantize: str | None = None) -> dict:
    """HF Qwen3-MoE checkpoint → stacked param tree (models/qwen3_moe.py
    layout, experts packed: ``w_gateup`` [L,NE,E,2F], gate first, and
    ``w_down`` [L,NE,F,E]). The expert stacks are filled one expert matrix
    at a time, straight into the layout the engine serves, so neither the
    host nor the card ever holds a second copy of them. ``quantize="int8"``:
    ``wqkv``, ``wo``, both expert stacks and an untied ``lm_head`` as ``{q,
    scales}``, each expert's gate|up matrix quantized once both halves are
    in; the router stays in ``dtype``."""
    L, NE, E, Fi = cfg.n_layers, cfg.n_experts, cfg.hidden, cfg.moe_intermediate
    dt = dtype or cfg.torch_dtype
    params = _convert_attention(raw, cfg, device, dt, quantize)
    lp = params["layers"]
    lp["router"] = _layer_stack(raw, L, "model.layers.{}.mlp.gate.weight", dt, device)
    gateup = _Stack((L, NE, E, 2 * Fi), dt, device, quantize)
    down = _Stack((L, NE, Fi, E), dt, device, quantize)
    for i in range(L):
        for e in range(NE):
            def mat(proj):
                return _to_torch(raw[f"model.layers.{i}.mlp.experts.{e}.{proj}.weight"].T,
                                 dt, device)

            gateup.set((i, e), slice(0, Fi), mat("gate_proj"), last=False)
            gateup.set((i, e), slice(Fi, 2 * Fi), mat("up_proj"))
            down.set((i, e), slice(None), mat("down_proj"))
    lp["w_gateup"], lp["w_down"] = gateup.out, down.out
    return params


def _deinterleave_rope_cols(w: np.ndarray, r: int) -> np.ndarray:
    """Permute the last ``r`` columns from interleaved (x0,y0,x1,y1,...) to
    half-split (x0,x1,...,y0,y1,...) rope layout (JAX ``weights.py:261``).

    Published DeepSeek-V3 / Kimi-K2 checkpoints store the rope columns of
    q_b_proj and kv_a_proj_with_mqa interleaved; HF's modeling code
    un-interleaves the activations at run time before rotate_half. This
    package's ``apply_rope`` is half-split, so the permutation is folded
    into the weights once, at conversion."""
    perm = np.concatenate([np.arange(0, r, 2), np.arange(1, r, 2)])
    out = np.array(w)
    out[..., -r:] = out[..., -r:][..., perm]
    return out


def convert_deepseek_v3(raw: Mapping[str, np.ndarray], cfg, device="cpu",
                        dtype: torch.dtype | None = None,
                        quantize: str | None = None) -> dict:
    """HF DeepSeek-V3 / Kimi-K2 checkpoint → the two-stack MLA tree
    (models/deepseek_v3.py layout, JAX ``weights.py:278``): kv_b_proj split
    into the absorbed key (``w_kb``) and the value (``w_vb``)
    up-projections, the rope columns of ``w_qb`` / ``w_kva``
    de-interleaved, the layers split into ``dense_layers`` (the first
    ``first_k_dense``) and ``moe_layers``. Every stack is filled one layer
    (or expert) matrix at a time. No int8 (:data:`INT8_MLA_REFUSED`)."""
    if quantize is not None:
        raise NotImplementedError(INT8_MLA_REFUSED)
    dt = dtype or cfg.torch_dtype
    E, H, LD = cfg.hidden, cfg.n_heads, cfg.first_k_dense
    QL, KL = cfg.q_lora_rank, cfg.kv_lora_rank
    QN, QR, VD = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    NE, Fi, FS, FD = (cfg.n_routed_experts, cfg.moe_intermediate,
                      cfg.moe_intermediate * cfg.n_shared_experts, cfg.dense_intermediate)

    def g(i, name):
        return raw[f"model.layers.{i}.{name}"]

    def stack(layers, shape, fn, sdt=dt):
        out = torch.empty((len(layers),) + shape, dtype=sdt, device=device)
        for j, i in enumerate(layers):
            out[j] = _to_torch(fn(i), sdt, device)
        return out

    def kv_b(i):
        return g(i, "self_attn.kv_b_proj.weight").T.reshape(KL, H, QN + VD)

    def q_b(i):
        qb = g(i, "self_attn.q_b_proj.weight").T.reshape(QL, H, QN + QR)
        return _deinterleave_rope_cols(qb, QR).reshape(QL, -1)

    def attn(layers):
        return {
            "ln1": stack(layers, (E,), lambda i: g(i, "input_layernorm.weight")),
            "ln2": stack(layers, (E,), lambda i: g(i, "post_attention_layernorm.weight")),
            "w_qa": stack(layers, (E, QL), lambda i: g(i, "self_attn.q_a_proj.weight").T),
            "q_a_norm": stack(layers, (QL,), lambda i: g(i, "self_attn.q_a_layernorm.weight")),
            "w_qb": stack(layers, (QL, H * (QN + QR)), q_b),
            "w_kva": stack(layers, (E, KL + QR), lambda i: _deinterleave_rope_cols(
                g(i, "self_attn.kv_a_proj_with_mqa.weight").T, QR)),
            "kv_a_norm": stack(layers, (KL,),
                               lambda i: g(i, "self_attn.kv_a_layernorm.weight")),
            "w_kb": stack(layers, (KL, H * QN), lambda i: kv_b(i)[:, :, :QN].reshape(KL, -1)),
            "w_vb": stack(layers, (KL, H * VD), lambda i: kv_b(i)[:, :, QN:].reshape(KL, -1)),
            "wo": stack(layers, (H * VD, E), lambda i: g(i, "self_attn.o_proj.weight").T),
        }

    def mlp(layers, prefix, keys, Fw):
        return {key: stack(layers, (Fw, E) if proj == "down_proj" else (E, Fw),
                           lambda i, p=proj: g(i, f"mlp.{prefix}{p}.weight").T)
                for key, proj in zip(keys, ("gate_proj", "up_proj", "down_proj"))}

    dense_ids, moe_ids = range(LD), range(LD, cfg.n_layers)
    dense = {**attn(dense_ids), **mlp(dense_ids, "", ("d_gate", "d_up", "d_down"), FD)}
    moe = {**attn(moe_ids),
           "router": stack(moe_ids, (E, NE), lambda i: g(i, "mlp.gate.weight").T),
           "router_bias": stack(moe_ids, (NE,),
                                lambda i: g(i, "mlp.gate.e_score_correction_bias"),
                                sdt=torch.float32),
           **mlp(moe_ids, "shared_experts.", ("s_gate", "s_up", "s_down"), FS)}
    for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
        shape = (Fi, E) if proj == "down_proj" else (E, Fi)
        out = torch.empty((len(moe_ids), NE) + shape, dtype=dt, device=device)
        for j, i in enumerate(moe_ids):
            for e in range(NE):
                out[j, e] = _to_torch(g(i, f"mlp.experts.{e}.{proj}.weight").T, dt, device)
        moe[key] = out
    params = {"embed": _to_torch(raw["model.embed_tokens.weight"], dt, device),
              "final_norm": _to_torch(raw["model.norm.weight"], dt, device),
              "dense_layers": dense, "moe_layers": moe}
    if "lm_head.weight" in raw and not cfg.tie_embeddings:
        params["lm_head"] = _to_torch(raw["lm_head.weight"].T, dt, device)
    return params


# the JAX reference serves no int8 MLA model: its quantize_params turns the
# absorbed up-projections w_kb / w_vb (QUANT_KEYS) into {q, scales} leaves,
# which its attention reshapes as arrays
INT8_MLA_REFUSED = (
    "int8 weights of the MLA family (DeepSeek-V3 / Kimi-K2) are refused: the JAX reference "
    "cannot serve them either — quantize='int8' turns w_kb / w_vb into {q, scales} leaves "
    "that deepsearch_tts_tpu/models/deepseek_v3.py:283 (_mla_q) reshapes as arrays "
    "(AttributeError: 'dict' object has no attribute 'reshape')")


def int8_refusal(cfg) -> str:
    """Why the family of ``cfg`` (its ``int8_weights`` unset) takes no int8
    weights."""
    if getattr(cfg, "latent_cache", False):
        return INT8_MLA_REFUSED
    return (f"model family config {type(cfg).__name__} sets no int8_weights: no int8 "
            f"weights path")


def random_params(cfg, device="cpu", seed: int = 0, quantize: str | None = None,
                  local=None) -> dict:
    """Random init on ``device`` in the packed layout the engine serves
    (``wqkv``, ``w_gateup``): normal·fan_in^-½ for matrices (the
    distribution of the JAX package's ``fast_random_params``: fan_in E for
    q/k/v, gate, up and the router, F for down), ones for the norms. Drawn
    on the device from a ``torch.Generator`` seeded with ``seed``, one
    matrix at a time, so the float32 draw never holds more than one [E,2F]
    (or [V,E]) slab — a whole qwen3-30b-a3b expert stack would take 38.7 GB
    in float32 — and no host-side weight bytes at all. ``quantize="int8"``
    draws the same numbers and quantizes each matrix of ``QUANT_KEYS`` as it
    is drawn: the result equals ``quantize_params(random_params(...))``.

    ``local`` (a ``parallel/sharding.LocalDraw``): every matrix is still
    drawn whole, in the same order, but only this rank's block of it is
    kept (the packed ``wqkv`` / ``w_gateup`` split into their parts first),
    so a rank holds its share of the weights and one matrix beside it; the
    tree is then this rank's unpacked slices, equal to ``shard_pytree`` of
    the whole draw unpacked (and quantized whole)."""
    from ..ops.quant import QUANT_KEYS

    if quantize is not None and not cfg.int8_weights:
        raise NotImplementedError(int8_refusal(cfg))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = cfg.torch_dtype
    E = cfg.hidden

    def mk(path, *shape, fan_in=None):
        fan = fan_in if fan_in is not None else shape[-2]
        quant = quantize if path[-1] in QUANT_KEYS else None
        st = (_Stack(shape, dt, dev, quant) if local is None
              else local.stack(path, shape, dt, dev, quant))
        for idx in np.ndindex(*shape[:-2]):
            st.set(idx, slice(None), torch.randn(shape[-2:], generator=gen, device=dev,
                                                 dtype=torch.float32).mul_(fan ** -0.5))
        return st.out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    if getattr(cfg, "latent_cache", False):
        params = _random_mla(cfg, mk, ones, dev)
    else:
        params = {"layers": _random_layers(cfg, mk, ones),
                  "embed": mk(("embed",), cfg.vocab_size, E, fan_in=E), "final_norm": ones(E)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mk(("lm_head",), E, cfg.vocab_size)
    return params if local is None else local.finish(params)


def _random_layers(cfg, mk, ones) -> dict:
    """The dense and the Qwen3-MoE families' ``layers`` stacks."""
    E, H, K, D, L = cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    layers = {
        "ln1": ones(L, E), "ln2": ones(L, E),
        "q_norm": ones(L, D), "k_norm": ones(L, D),
        "wqkv": mk(("layers", "wqkv"), L, E, (H + 2 * K) * D),
        "wo": mk(("layers", "wo"), L, H * D, E),
    }
    # the family's MLP stacks; every one has its fan_in second to last
    layers.update({k: mk(("layers", k), L, *shape) for k, shape in cfg.mlp_shapes().items()})
    return layers


def _random_mla(cfg, mk, ones, dev) -> dict:
    """The MLA family's two-stack tree (``models/deepseek_v3.py``): every
    matrix drawn on its own (one [E,F] expert matrix at a time: a
    deepseek-v3 expert stack is 11.3 B values, 45 GB in float32), the
    router bias zero."""
    E, H, L, LD = cfg.hidden, cfg.n_heads, cfg.n_layers, cfg.first_k_dense
    QL, KL = cfg.q_lora_rank, cfg.kv_lora_rank
    QN, QR, VD = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    NE, Fi, FS, FD = (cfg.n_routed_experts, cfg.moe_intermediate,
                      cfg.moe_intermediate * cfg.n_shared_experts, cfg.dense_intermediate)

    def attn(g, n):
        return {"ln1": ones(n, E), "ln2": ones(n, E), "w_qa": mk((g, "w_qa"), n, E, QL),
                "q_a_norm": ones(n, QL), "w_qb": mk((g, "w_qb"), n, QL, H * (QN + QR)),
                "w_kva": mk((g, "w_kva"), n, E, KL + QR), "kv_a_norm": ones(n, KL),
                "w_kb": mk((g, "w_kb"), n, KL, H * QN), "w_vb": mk((g, "w_vb"), n, KL, H * VD),
                "wo": mk((g, "wo"), n, H * VD, E)}

    LM, d, m = L - LD, "dense_layers", "moe_layers"
    dense = {**attn(d, LD), "d_gate": mk((d, "d_gate"), LD, E, FD),
             "d_up": mk((d, "d_up"), LD, E, FD), "d_down": mk((d, "d_down"), LD, FD, E)}
    moe = {**attn(m, LM), "router": mk((m, "router"), LM, E, NE),
           "router_bias": torch.zeros((LM, NE), dtype=torch.float32, device=dev),
           "w_gate": mk((m, "w_gate"), LM, NE, E, Fi), "w_up": mk((m, "w_up"), LM, NE, E, Fi),
           "w_down": mk((m, "w_down"), LM, NE, Fi, E),
           "s_gate": mk((m, "s_gate"), LM, E, FS), "s_up": mk((m, "s_up"), LM, E, FS),
           "s_down": mk((m, "s_down"), LM, FS, E)}
    return {"embed": mk(("embed",), cfg.vocab_size, E, fan_in=E), "final_norm": ones(E),
            "dense_layers": dense, "moe_layers": moe}


def _cat_columns(parts: list):
    """Concat stacked matrices over output columns; int8 ``{q, scales}``
    leaves concat both (per-column scales: quantizing the packed matrix
    gives the same)."""
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k] for p in parts], dim=-1) for k in ("q", "scales")}
    return torch.cat(parts, dim=-1)


def pack_matmul_params(params: dict) -> dict:
    """Fuse per-layer QKV and gate/up weights into one matrix each (a concat
    over output columns: numerically the identity) — dense [L,E,F] and
    expert [L,NE,E,F] stacks, bf16 or int8 ``{q, scales}``, alike. The fused
    decode kernels read this packed layout. Tensors of an already-packed
    tree are handed back as they are, so engines built on one tree share
    one copy of the weights. The MLA families' two-stack tree (no
    ``layers``) is handed back unchanged, as in JAX (``weights.py:374``)."""
    if "layers" not in params:
        return params
    lp = dict(params["layers"])
    if all(k in lp for k in ("wq", "wk", "wv")):
        lp["wqkv"] = _cat_columns([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")])
    if "w_gate" in lp and "w_up" in lp:
        lp["w_gateup"] = _cat_columns([lp.pop("w_gate"), lp.pop("w_up")])
    out = dict(params)
    out["layers"] = lp
    return out


def unpack_matmul_params(params: dict, cfg) -> dict:
    """Inverse of :func:`pack_matmul_params` (plain-tensor weights only;
    JAX ``weights.py:390``): ``wq`` / ``wk`` / ``wv`` and ``w_gate`` /
    ``w_up`` as column views of the packed leaves, no copy. int8 ``{q,
    scales}`` packed leaves raise JAX's ``ValueError``."""
    if "layers" not in params:
        return params
    lp = dict(params["layers"])
    if "wqkv" in lp:
        w = lp.pop("wqkv")
        if isinstance(w, dict):
            raise ValueError("cannot unpack int8-quantized packed weights")
        hd = cfg.n_heads * cfg.head_dim
        kd = cfg.n_kv_heads * cfg.head_dim
        lp["wq"], lp["wk"], lp["wv"] = (
            w[..., :hd], w[..., hd:hd + kd], w[..., hd + kd:])
    if "w_gateup" in lp:
        w = lp.pop("w_gateup")
        if isinstance(w, dict):
            raise ValueError("cannot unpack int8-quantized packed weights")
        Fi = w.shape[-1] // 2
        lp["w_gate"], lp["w_up"] = w[..., :Fi], w[..., Fi:]
    out = dict(params)
    out["layers"] = lp
    return out


def params_from_jax(tree, device="cpu") -> dict:
    """The JAX package's param tree, as numpy arrays, → this port's tree.

    bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy) are reinterpreted bit
    for bit — viewed as int16, then as ``torch.bfloat16`` — so this package
    never imports ``ml_dtypes``; other leaves keep their dtype (int8 ``{q,
    scales}`` leaves of a quantized tree included). ``None`` leaves and
    Python (or numpy) scalars pass through as Python values, so a JAX LoRA
    tree (``train/lora.py``: ``None`` off the adapted weights, ``alpha`` and
    ``rank`` numbers) converts too."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree      # a LoRA tree's empty leaves and its alpha / rank
    if isinstance(tree, np.generic):
        return tree.item()
    a = np.array(tree)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def load_or_init_params(model_name: str, weights_path: str = "", seed: int = 0,
                        device="cpu", quantize: str | None = None) -> tuple[dict, str]:
    """Return (params, resolved model name). Random init when no weights;
    ``quantize="int8"``: the int8 tree, built one matrix at a time."""
    from ..models.registry import get_model

    fam = get_model(model_name)
    if weights_path:
        raw = _load_safetensors_dir(weights_path)
        return fam.convert(raw, fam.config, device=device, quantize=quantize), fam.name
    return init_params(fam, device=device, seed=seed, quantize=quantize), fam.name


def init_params(fam, device="cpu", seed: int = 0, quantize: str | None = None) -> dict:
    """A registered family's params without a checkpoint: its own
    ``init_params`` where the config sets ``custom_init`` (registry-extension
    families, whose configs need not carry Qwen3's fields; JAX
    ``weights.py:429-432``), else :func:`random_params`."""
    cfg = fam.config
    if not getattr(cfg, "custom_init", False):
        return random_params(cfg, device=device, seed=seed, quantize=quantize)
    if fam.init_params is None:
        raise ValueError(f"model family {fam.name!r} sets custom_init but was registered "
                         f"without init_params")
    if quantize is not None and not getattr(cfg, "int8_weights", False):
        raise NotImplementedError(int8_refusal(cfg))
    return fam.init_params(cfg, seed=seed, device=torch.device(device))
