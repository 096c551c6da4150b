"""On-chip transformer encoder for batch embedding generation.

The reference embeds via a remote HTTPS API (text-embedding-v4,
src/lib/llm/config.ts:31; dim-1024 qwen_embedding,
lightrag-service/main.py:104-139) — one network call per batch. Here the
encoder is an XLA-compiled transformer running on the same chips as the
index, so chunk -> tokenize -> embed -> index is one on-chip pipeline
(SURVEY.md §7.8).

Design: pre-LN transformer, mean-pooled, projected, L2-normalized.
Pure-pytree params (no framework dep) with explicit tensor-parallel
PartitionSpecs: attention heads and MLP hidden shard over the 'model'
mesh axis; the query/chunk batch shards over 'data'. Weights load from
any checkpoint that matches the tree; random-init is deterministic for
tests and benchmarking (throughput is weight-independent).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpurag.ingest.tokenizer import tokenize


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    mlp_ratio: int = 4
    max_len: int = 512          # chunks are 512 tokens (config.ts:70-74)
    out_dim: int = 1024         # embedding dim parity (main.py:188)
    dtype: str = "bfloat16"
    # 'preln': the native bias-free pre-LN stack (fast, train-from-
    # scratch). 'bert': faithful post-LN BERT with biases + embedding
    # LayerNorm — the arch externally-trained HF checkpoints need
    # (import_hf_bert maps hugging-face names onto this tree).
    arch: str = "preln"
    ln_eps: float = 1e-6        # BERT checkpoints use 1e-12

    @classmethod
    def base(cls, **overrides) -> "EncoderConfig":
        """Production shape: BERT-base (12L / dim 768 / 12 heads /
        512-token context, ~110M params) projecting to the dim-1024
        embedding space — the scale class of the reference's remote
        embedding model (config.ts:31 text-embedding-v4), vs. the
        4L/512 default that exists for fast tests."""
        kw = dict(dim=768, n_layers=12, n_heads=12, max_len=512,
                  out_dim=1024, dtype="bfloat16")
        kw.update(overrides)
        return cls(**kw)


def init_params(cfg: EncoderConfig, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(cfg.dtype)
    d, h = cfg.dim, cfg.dim * cfg.mlp_ratio

    def w(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[0]))
        return jnp.asarray(
            rng.standard_normal(shape).astype(np.float32) * scale, dt)

    def ln():
        return {"g": jnp.ones((d,), dt), "b": jnp.zeros((d,), dt)}

    if cfg.arch == "bert":
        params = {
            "tok_emb": w(cfg.vocab_size, d, scale=0.02),
            "pos_emb": w(cfg.max_len, d, scale=0.02),
            "type_emb": w(2, d, scale=0.02),
            "emb_ln": ln(),
            "layers": [],
        }
        if cfg.out_dim != cfg.dim:
            params["out_proj"] = w(d, cfg.out_dim)
        for _ in range(cfg.n_layers):
            params["layers"].append({
                "ln1": ln(), "ln2": ln(),
                "wq": w(d, d), "bq": jnp.zeros((d,), dt),
                "wk": w(d, d), "bk": jnp.zeros((d,), dt),
                "wv": w(d, d), "bv": jnp.zeros((d,), dt),
                "wo": w(d, d), "bo": jnp.zeros((d,), dt),
                "w1": w(d, h), "b1": jnp.zeros((h,), dt),
                "w2": w(h, d), "b2": jnp.zeros((d,), dt),
            })
        return params
    params = {
        "tok_emb": w(cfg.vocab_size, d, scale=0.02),
        "pos_emb": w(cfg.max_len, d, scale=0.02),
        "out_proj": w(d, cfg.out_dim),
        "final_ln": ln(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": ln(), "ln2": ln(),
            "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
            "w1": w(d, h), "w2": w(h, d),
        })
    return params


def param_specs(cfg: EncoderConfig) -> dict:
    """Tensor-parallel PartitionSpecs: head dim / MLP hidden over 'model'."""
    if cfg.arch == "bert":
        layer = {
            "ln1": {"g": P(), "b": P()},
            "ln2": {"g": P(), "b": P()},
            "wq": P(None, "model"), "bq": P("model"),
            "wk": P(None, "model"), "bk": P("model"),
            "wv": P(None, "model"), "bv": P("model"),
            "wo": P("model", None), "bo": P(),
            "w1": P(None, "model"), "b1": P("model"),
            "w2": P("model", None), "b2": P(),
        }
        specs = {
            "tok_emb": P(),
            "pos_emb": P(),
            "type_emb": P(),
            "emb_ln": {"g": P(), "b": P()},
            "layers": [layer] * cfg.n_layers,
        }
        if cfg.out_dim != cfg.dim:
            specs["out_proj"] = P(None, "model")
        return specs
    layer = {
        "ln1": {"g": P(), "b": P()},
        "ln2": {"g": P(), "b": P()},
        "wq": P(None, "model"), "wk": P(None, "model"),
        "wv": P(None, "model"), "wo": P("model", None),
        "w1": P(None, "model"), "w2": P("model", None),
    }
    return {
        "tok_emb": P(),
        "pos_emb": P(),
        "out_proj": P(None, "model"),
        "final_ln": {"g": P(), "b": P()},
        "layers": [layer] * cfg.n_layers,
    }


def shard_params(params: dict, cfg: EncoderConfig, mesh: Mesh) -> dict:
    specs = param_specs(cfg)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, specs,
        is_leaf=lambda x: isinstance(x, jax.Array) or hasattr(x, "shape"))


def _ln(x, g, b, eps=1e-6):
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.var(x32, axis=-1, keepdims=True)
    return ((x32 - mu) * jax.lax.rsqrt(var + eps)).astype(x.dtype) * g + b


def _bert_block(x, p, n_heads: int, mask, eps: float):
    """Post-LN BERT layer (biases everywhere, exact GELU) — matches
    transformers.BertLayer numerics for imported checkpoints."""
    b, s, d = x.shape
    hd = d // n_heads
    q = (x @ p["wq"] + p["bq"]).reshape(b, s, n_heads, hd)
    k = (x @ p["wk"] + p["bk"]).reshape(b, s, n_heads, hd)
    v = (x @ p["wv"] + p["bv"]).reshape(b, s, n_heads, hd)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                     preferred_element_type=jnp.float32) / np.sqrt(hd)
    att = jnp.where(mask[:, None, None, :], att, -1e30)
    att = jax.nn.softmax(att, axis=-1).astype(x.dtype)
    o = jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, d)
    x = _ln(x + o @ p["wo"] + p["bo"], p["ln1"]["g"], p["ln1"]["b"], eps)
    h = jax.nn.gelu(x @ p["w1"] + p["b1"], approximate=False)
    return _ln(x + h @ p["w2"] + p["b2"], p["ln2"]["g"], p["ln2"]["b"], eps)


def _block(x, p, n_heads: int, mask):
    b, s, d = x.shape
    hd = d // n_heads
    h = _ln(x, p["ln1"]["g"], p["ln1"]["b"])
    q = (h @ p["wq"]).reshape(b, s, n_heads, hd)
    k = (h @ p["wk"]).reshape(b, s, n_heads, hd)
    v = (h @ p["wv"]).reshape(b, s, n_heads, hd)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                     preferred_element_type=jnp.float32) / np.sqrt(hd)
    att = jnp.where(mask[:, None, None, :], att, -1e30)
    att = jax.nn.softmax(att, axis=-1).astype(x.dtype)
    o = jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, d)
    x = x + o @ p["wo"]
    h = _ln(x, p["ln2"]["g"], p["ln2"]["b"])
    x = x + jax.nn.gelu(h @ p["w1"]) @ p["w2"]
    return x


@functools.partial(jax.jit, static_argnames=("n_heads", "ln_eps"))
def encode_tokens(params: dict, token_ids: jax.Array, mask: jax.Array,
                  n_heads: int = 8, ln_eps: float = 1e-6) -> jax.Array:
    """token_ids/mask: (B, S) int32/bool -> (B, out_dim) float32, normalized.

    The arch is selected by the parameter tree: a BERT tree (emb_ln
    present — imported checkpoints) runs the faithful post-LN stack;
    the native tree runs the bias-free pre-LN stack."""
    s = token_ids.shape[1]
    x = params["tok_emb"][token_ids] + params["pos_emb"][:s][None]
    if "emb_ln" in params:  # BERT: + segment-0 embedding, embedding LN
        x = x + params["type_emb"][0][None, None]
        x = _ln(x, params["emb_ln"]["g"], params["emb_ln"]["b"], ln_eps)
        for layer in params["layers"]:
            x = _bert_block(x, layer, n_heads, mask, ln_eps)
    else:
        for layer in params["layers"]:
            x = _block(x, layer, n_heads, mask)
        x = _ln(x, params["final_ln"]["g"], params["final_ln"]["b"])
    denom = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
    pooled = jnp.sum(jnp.where(mask[:, :, None], x, 0), axis=1) / denom
    if "out_proj" in params:
        pooled = pooled @ params["out_proj"]
    out = pooled.astype(jnp.float32)
    return out / jnp.maximum(jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-30)


def hash_token_ids(texts: list[str], cfg: EncoderConfig,
                   seq_len: Optional[int] = None):
    """Hash-vocabulary tokenization (host side; a learned-vocab tokenizer
    plugs in the same way). Returns (ids, mask) int32/bool (B, S)."""
    import hashlib

    s = seq_len or cfg.max_len
    ids = np.zeros((len(texts), s), np.int32)
    mask = np.zeros((len(texts), s), bool)
    for i, t in enumerate(texts):
        toks = tokenize(t)[:s]
        for j, tok in enumerate(toks):
            hv = int.from_bytes(
                hashlib.blake2b(tok.encode(), digest_size=4).digest(), "little")
            ids[i, j] = hv % cfg.vocab_size
        mask[i, : len(toks)] = True
        if not toks:
            mask[i, 0] = True
    return jnp.asarray(ids), jnp.asarray(mask)


# -- checkpointing (npz pytree) -----------------------------------------------


def _flatten_params(params: dict, prefix: str = "") -> dict:
    flat = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(_flatten_params(v, f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(_flatten_params(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = params
    return flat


def save_params(params: dict, cfg: EncoderConfig, path) -> None:
    """One npz checkpoint: dotted-path keys + dtype table + config.
    bf16 leaves persist as raw 2-byte payloads (uint16 view), so a
    load reproduces embeddings bit-exactly."""
    import json
    import pathlib

    flat = _flatten_params(params)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        a = np.asarray(v)
        dtypes[k] = str(a.dtype)
        if a.dtype == jnp.bfloat16:
            a = a.view(np.uint16)
        arrays[k] = a
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, __dtypes__=json.dumps(dtypes),
             __config__=json.dumps(dataclasses.asdict(cfg)), **arrays)


def load_params(path) -> tuple[dict, EncoderConfig]:
    """Inverse of save_params: returns (params pytree, config)."""
    import json
    import pathlib

    data = np.load(pathlib.Path(path).with_suffix(".npz"),
                   allow_pickle=False)
    dtypes = json.loads(str(data["__dtypes__"]))
    cfg = EncoderConfig(**json.loads(str(data["__config__"])))
    params = init_params(cfg)  # structural template
    flat_template = _flatten_params(params)

    def build(node, prefix=""):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        key = prefix[:-1]
        arr = data[key]
        if dtypes[key] == "bfloat16":
            arr = arr.view(jnp.bfloat16)
        return jnp.asarray(arr)

    assert set(flat_template) == {k for k in data.files
                                  if not k.startswith("__")}, \
        "checkpoint tree does not match the config's parameter tree"
    return build(params), cfg


class EncoderEmbedder:
    """Embedder-protocol adapter: texts -> (B, out_dim) numpy.

    tokenizer: optional callable (texts, seq_len) -> (ids, mask) — e.g.
    tpurag.ingest.subword.SubwordTokenizer (the learned-vocab slot);
    hash-vocab tokenization otherwise."""

    def __init__(self, cfg: Optional[EncoderConfig] = None, seed: int = 0,
                 params: Optional[dict] = None, seq_len: int = 128,
                 tokenizer=None, mesh: Optional[Mesh] = None):
        self.cfg = cfg or EncoderConfig()
        self.params = params if params is not None else init_params(self.cfg, seed)
        if mesh is not None:
            self.params = shard_params(self.params, self.cfg, mesh)
        self.dim = self.cfg.out_dim
        self.seq_len = seq_len
        self.tokenizer = tokenizer

    def _tokens(self, texts: list[str]):
        if self.tokenizer is not None:
            ids, mask = self.tokenizer(texts, self.seq_len)
            return jnp.asarray(ids), jnp.asarray(mask)
        return hash_token_ids(texts, self.cfg, self.seq_len)

    def encode_async(self, texts: list[str]) -> jax.Array:
        """Dispatch without blocking (jax async dispatch): the returned
        device array materializes later — the double-buffered ingest
        feed tokenizes the next batch while this one encodes.

        The batch axis pads to a power-of-two bucket so a stream of
        ragged batches compiles O(log B) encode variants, not one per
        size (padding rows are sliced off the output)."""
        n = len(texts)
        bucket = 1 << max(n - 1, 0).bit_length() if n > 1 else 1
        padded = texts + [""] * (bucket - n)
        ids, mask = self._tokens(padded)
        out = encode_tokens(self.params, ids, mask,
                            n_heads=self.cfg.n_heads,
                            ln_eps=self.cfg.ln_eps)
        return out[:n]

    def __call__(self, texts: list[str]) -> np.ndarray:
        return np.asarray(self.encode_async(texts))

    # -- persistence ---------------------------------------------------------

    def save(self, path) -> None:
        save_params(self.params, self.cfg, path)

    @classmethod
    def load(cls, path, seq_len: int = 128, tokenizer=None,
             mesh: Optional[Mesh] = None) -> "EncoderEmbedder":
        params, cfg = load_params(path)
        return cls(cfg, params=params, seq_len=seq_len,
                   tokenizer=tokenizer, mesh=mesh)

    @classmethod
    def from_hf(cls, src, seq_len: int = 128, dtype: str = "float32",
                out_dim: Optional[int] = None, tokenizer=None,
                mesh: Optional[Mesh] = None) -> "EncoderEmbedder":
        """Build from an externally-trained BERT checkpoint (HF naming;
        local dir or in-memory transformers model). When `tokenizer` is
        a transformers tokenizer it is adapted automatically."""
        from tpurag.models.import_hf import (hf_tokenizer_adapter,
                                             import_hf_bert)

        params, cfg = import_hf_bert(src, dtype=dtype, out_dim=out_dim)
        if tokenizer is not None and hasattr(tokenizer,
                                             "batch_encode_plus"):
            tokenizer = hf_tokenizer_adapter(tokenizer)  # HF tokenizer
        return cls(cfg, params=params, seq_len=seq_len,
                   tokenizer=tokenizer, mesh=mesh)
