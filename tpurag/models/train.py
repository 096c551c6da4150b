"""On-chip contrastive training for the encoder (round-2 verdict item 5b).

The reference gets semantic retrieval from an externally-trained
embedding model (src/lib/llm/config.ts:31); tpurag can import one
(models/import_hf.py) — and, in zero-egress environments with no
checkpoint available, train its own: symmetric InfoNCE over text pairs,
in-batch negatives, the whole step (fwd + bwd + adam) one XLA program on
the same chip that serves the index.

Device notes: the batch rides one (B, D)x(D, B) logits matmul;
static shapes throughout (pairs are pre-tokenized to a fixed seq_len);
donate the (params, opt_state) pair so the optimizer updates in place.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpurag.models.encoder import EncoderConfig, encode_tokens, init_params


def info_nce(za: jax.Array, zb: jax.Array, temp: float) -> jax.Array:
    """Symmetric InfoNCE over L2-normalized views (B, D) x (B, D)."""
    logits = (za @ zb.T) / temp
    labels = jnp.arange(za.shape[0])
    l_ab = -jnp.mean(jax.nn.log_softmax(logits, axis=1)[labels, labels])
    l_ba = -jnp.mean(jax.nn.log_softmax(logits, axis=0)[labels, labels])
    return 0.5 * (l_ab + l_ba)


def make_train_step(optimizer, n_heads: int, ln_eps: float,
                    temp: float = 0.07):
    """One jitted (params, opt_state, batch) -> (params, opt_state, loss)
    step; optimizer is any optax GradientTransformation."""

    def loss_fn(params, ids_a, mask_a, ids_b, mask_b):
        za = encode_tokens(params, ids_a, mask_a, n_heads=n_heads,
                           ln_eps=ln_eps)
        zb = encode_tokens(params, ids_b, mask_b, n_heads=n_heads,
                           ln_eps=ln_eps)
        return info_nce(za, zb, temp)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, ids_a, mask_a, ids_b, mask_b):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, ids_a, mask_a, ids_b, mask_b)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax

        return optax.apply_updates(params, updates), opt_state, loss

    return step


def train_contrastive(cfg: EncoderConfig, pair_texts, tokenizer=None,
                      steps: int = 300, batch: int = 64,
                      lr: float = 2e-3, temp: float = 0.07,
                      seed: int = 0, seq_len: int = 16,
                      params: dict | None = None, log=None):
    """Train an encoder on (text_a, text_b) positive pairs.

    pair_texts: sequence of (a, b) string tuples; tokenizer: optional
    (texts, seq_len) -> (ids, mask) (hash tokens otherwise). Returns the
    trained params pytree.
    """
    import optax

    from tpurag.models.encoder import hash_token_ids

    def toks(texts):
        if tokenizer is not None:
            ids, mask = tokenizer(texts, seq_len)
            return jnp.asarray(ids), jnp.asarray(mask)
        return hash_token_ids(texts, cfg, seq_len)

    a_texts = [a for a, _ in pair_texts]
    b_texts = [b for _, b in pair_texts]
    ids_a, mask_a = toks(a_texts)
    ids_b, mask_b = toks(b_texts)
    ids_a, mask_a, ids_b, mask_b = map(np.asarray,
                                       (ids_a, mask_a, ids_b, mask_b))

    params = params if params is not None else init_params(cfg, seed)
    optimizer = optax.adamw(lr)
    opt_state = optimizer.init(params)
    step = make_train_step(optimizer, cfg.n_heads, cfg.ln_eps, temp)
    rng = np.random.default_rng(seed)
    n = len(pair_texts)
    for i in range(steps):
        sel = rng.choice(n, size=min(batch, n), replace=False)
        params, opt_state, loss = step(
            params, opt_state,
            jnp.asarray(ids_a[sel]), jnp.asarray(mask_a[sel]),
            jnp.asarray(ids_b[sel]), jnp.asarray(mask_b[sel]))
        if log and (i % 50 == 0 or i == steps - 1):
            log(f"step {i}: loss {float(loss):.4f}")
    return params
