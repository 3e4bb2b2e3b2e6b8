"""Shared checks of a whole decoder-only model against the JAX package, for
the parity tests of the recurrent, hybrid and VLM families
(``test_torch_mamba.py``, ``test_torch_xlstm.py``, ``test_torch_vlm.py``).

``run(name)`` builds the arch's ``reduced()`` config in both packages,
draws the weights once (the port's seeded ``init_params``, which has the
reference's tree leaf for leaf: the JAX init of a reduced jamba alone
takes ~6 s on the CPU), hands them to the JAX side as arrays and to the
port through ``params_from_reference``, and runs the three calls of
``tests/test_models_smoke.py`` on one seeded numpy batch: the forward
logits, one train step's loss and gradients, and one decode step from a
cache filled to index 4.  The JAX side is jitted, as ``launch/`` runs it.
Tolerances (f32 compute): logits at atol = rtol = 1e-4 (the whole-model
bound of ``tests/test_torch_models.py``), the loss at rtol 1e-5, each
gradient to 1e-4 of the largest |g| of the model plus 1e-4 of its own
|g| (a leaf whose exact gradient is 0, such as sLSTM's input-gate bias
under the −1e30 stabiliser, holds rounding noise in both packages).

The parity modules import ``one_thread``, which keeps torch on one thread
while they run: their tensors are small, and beside the other test
workers each worker's default pool of one thread a core oversubscribes
the CPU (these modules' summed test time fell from 319 s to 123 s under
six workers).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import transformer as j_tf
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import transformer as t_tf

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread for the module (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, T, S, INDEX = 2, 16, 24, 4  # tests/test_models_smoke.py


def lm_batch(cfg, seed: int = 0, B: int = B, T: int = T) -> dict:
    """tokens / labels, and for the VLM 4 patch embeddings and M-RoPE ids
    (t, t // 2, t // 2), as ``tests/test_models_smoke.py::_lm_batch``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(size=(B, 4, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(T), (B, T))
        batch["mrope_positions"] = np.stack([pos, pos // 2, pos // 2])
    return batch


def flat(tree) -> dict:
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {pytree.keystr(p): x.detach().numpy()
                for p, x in pytree.tree_leaves_with_path(tree)}
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_side(jc, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def logits(p, b):
        return j_tf.forward(p, jc, b["tokens"], mrope_positions=b.get("mrope_positions"),
                            vision_embeds=b.get("vision_embeds"))[0]

    def step(p, t):
        cache = j_tf.init_cache(jc, B, S, jnp.float32, index=INDEX)
        return j_tf.decode_step(p, jc, t, cache)[0]

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_tf.loss_fn(p, jc, b), has_aux=True))(jp, jb)
    return {"logits": np.asarray(jax.jit(logits)(jp, jb)), "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": flat(grads),
            "decode": np.asarray(jax.jit(step)(jp, jb["tokens"][:, :1]))}


def _port_side(tc, tp, batch):
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    kw = {k: tb.get(k) for k in ("mrope_positions", "vision_embeds")}
    with torch.no_grad():
        logits = t_tf.forward(tp, tc, tb["tokens"], **kw)[0]
        cache = t_tf.init_cache(tc, B, S, torch.float32, index=INDEX)
        dec = t_tf.decode_step(tp, tc, tb["tokens"][:, :1], cache)[0]
    leaves = pytree.tree_map(lambda x: x.clone().requires_grad_(True), tp)
    loss, metrics = t_tf.loss_fn(leaves, tc, tb)
    loss.backward()
    return {"logits": logits.numpy(), "loss": float(loss.detach()),
            "metrics": {k: float(torch.as_tensor(v).detach()) for k, v in metrics.items()},
            "grads": flat(pytree.tree_map(lambda x: x.grad, leaves)), "decode": dec.numpy()}


def run(name: str, seed: int = 0) -> dict:
    """Both packages' results for the reduced ``name``, keyed "jax" /
    "port", with the configs."""
    jc, tc = j_get_config(name).reduced(), t_get_config(name).reduced()
    weights = pytree.tree_map(lambda x: x.numpy(),
                              t_tf.init_params(torch.Generator().manual_seed(seed), tc,
                                               device="cpu"))
    jp = jax.tree.map(jnp.asarray, weights)
    tp = params_from_reference(weights, "cpu")
    batch = lm_batch(jc, seed)
    return {"cfg": tc, "jax": _jax_side(jc, jp, batch), "port": _port_side(tc, tp, batch)}


def check_logits(got, want, vocab: int, tol: float = LOGIT_TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :vocab], want[..., :vocab], atol=tol, rtol=tol)
    np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])  # the −1e30 pad


def check_train_step(r: dict):
    j, t = r["jax"], r["port"]
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
    assert t["metrics"].keys() == j["metrics"].keys()
    for k in j["metrics"]:
        np.testing.assert_allclose(t["metrics"][k], j["metrics"][k], rtol=LOSS_RTOL, atol=1e-7)
    assert t["grads"].keys() == j["grads"].keys()
    scale = max(float(np.abs(g).max()) for g in j["grads"].values())
    assert np.isfinite(scale) and scale > 0
    for k, g in j["grads"].items():
        np.testing.assert_allclose(t["grads"][k], g, atol=GRAD_TOL * scale, rtol=GRAD_TOL,
                                   err_msg=k)


def decode_all(step, params, toks, cache, to_tokens):
    """Token-by-token decode of ``toks`` (B, T) by ``step(params, tok,
    cache) → (logits, cache)`` → logits (B, T, V) as numpy."""
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, to_tokens(toks[:, t:t + 1]), cache)
        outs.append(lg[:, 0].numpy() if isinstance(lg, torch.Tensor) else np.asarray(lg[:, 0]))
    return np.stack(outs, axis=1)


def jax_steps(jc):
    """The reference's forward logits and decode step, jitted for ``jc``."""
    forward = jax.jit(lambda p, t: j_tf.forward(p, jc, t)[0])
    step = jax.jit(lambda p, t, c: j_tf.decode_step(p, jc, t, c))
    return forward, step
