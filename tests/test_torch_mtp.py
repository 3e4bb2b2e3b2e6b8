"""Port parity: the training loss of the MLA / MoE / MTP models — DeepSeek-V3's
multi-token prediction (``mtp_hidden`` and the MTP branch of ``loss_fn``),
olmoe-1b-7b's MoE aux and minicpm3-4b's MLA — against the JAX package, and
the three full-width parameter trees without memory.

Weights cross with ``convert.params_from_reference`` and batches are the
reference's ``synthetic_lm_batches``, at the reduced configs (2 layers,
d_model 256, f32 compute) on the CPU.  Tolerances are
``tests/test_torch_train.py``'s ``test_loss_and_grads_match_jax``: the
loss and each of its metrics (``ce``, ``aux``, ``mtp``) to rtol 1e-5, each
gradient leaf to 1e-5 × its max |g|.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import synthetic_lm_batches as j_batches  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

RTOL = 1e-5
GRAD_TOL = 1e-5  # × the leaf's max |g|
B, T = 2, 32
ARCHS = ["deepseek-v3-671b", "olmoe-1b-7b", "minicpm3-4b"]


def _flat(tree) -> dict:
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {pytree.keystr(p): x.detach().numpy()
                for p, x in pytree.tree_leaves_with_path(tree)}
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _setup(name):
    jc, tc = j_get_config(name).reduced(), t_get_config(name).reduced()
    jp = j_tf.init_params(jax.random.key(0), jc)
    batch = jax.tree.map(np.asarray, next(j_batches(0, B, T, jc.vocab_size)))
    return jc, tc, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu"), batch


def _t_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_loss_metrics_and_grads_match_jax(name):
    jc, tc, jp, tp, batch = _setup(name)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_tf.loss_fn(p, jc, batch),
                                              has_aux=True))(jax.tree.map(jnp.asarray, jp))
    leaves, spec = tree_flatten(tp)
    xs = [x.requires_grad_() for x in leaves]
    tl, tm = t_tf.loss_fn(pytree.tree_unflatten(xs, spec), tc, _t_batch(batch))
    tm = {k: v.detach() for k, v in tm.items()}
    tg = pytree.tree_unflatten(list(torch.autograd.grad(tl, xs)), spec)
    assert sorted(tm) == sorted(jm) == (["aux", "ce", "mtp"] if jc.num_mtp_layers else
                                        ["aux", "ce"])
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, err_msg=k)
    assert (float(tm["aux"]) > 0) == (jc.moe is not None)
    jf, tf_ = _flat(jg), _flat(tg)
    assert sorted(jf) == sorted(tf_)
    for k, a in jf.items():
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(tf_[k], a, rtol=0, atol=GRAD_TOL * scale, err_msg=k)
    if jc.num_mtp_layers:  # the MTP branch reaches its own weights
        assert all(float(np.abs(v).max()) > 0 for k, v in tf_.items() if k.startswith("['mtp']"))


def test_mtp_hidden_matches_jax():
    """The depth-1 trunk alone, on the forward's hidden states and the
    shifted tokens: its states and its MoE aux."""
    jc, tc, jp, tp, batch = _setup("deepseek-v3-671b")
    toks = batch["tokens"]
    pos = np.broadcast_to(np.arange(T), (B, T))
    nxt = np.roll(toks, -1, axis=1)

    @jax.jit
    def reference(p, toks, nxt, pos):
        _, _, _, h = j_tf.forward(p, jc, toks, return_hidden=True, skip_logits=True)
        return (h,) + j_tf.mtp_hidden(p, jc, h, nxt, pos)

    jh, jx, jaux = reference(jp, jnp.asarray(toks), jnp.asarray(nxt), jnp.asarray(pos))
    tx, taux = t_tf.mtp_hidden(tp, tc, torch.from_numpy(np.asarray(jh)),
                               torch.from_numpy(nxt).long(), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_tree_matches_reference_shapes(name):
    """The full config's tree on the meta device: every leaf's name, shape
    and type as ``jax.eval_shape(init_params)`` gives them (the expert
    stacks, the f32 router, the MLA projections, ``mtp``)."""
    jc, tc = j_get_config(name), t_get_config(name)
    shapes = jax.eval_shape(lambda k: j_tf.init_params(k, jc), jax.random.key(0))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
    tp = t_tf.init_params(torch.Generator(), tc, device="meta")
    got = {pytree.keystr(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in pytree.tree_leaves_with_path(tp)}
    assert got == want
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert n == {"deepseek-v3-671b": 682_636_472_320, "olmoe-1b-7b": 6_919_620_608,
                 "minicpm3-4b": 4_073_937_408}[name]


def test_train_cli_deepseek_reduced(capsys, monkeypatch):
    """``launch.train --arch deepseek-v3-671b --reduced`` with the top-k
    wire: MLA, first-k dense, MoE with a shared expert and the MTP trunk
    run every step, and the losses are finite (the loss falling over 8
    steps is ``chip_smoke.py``'s check; the CLI at this size trains slowly
    on a CPU shared by the test workers)."""
    calls = []
    mtp_hidden = t_tf.mtp_hidden
    monkeypatch.setattr(t_tf, "mtp_hidden", lambda *a, **k: calls.append(1) or mtp_hidden(*a, **k))
    hist = t_train.main(["--arch", "deepseek-v3-671b", "--reduced", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--log-every", "1",
                         "--compress-topk", "0.25", "--lr", "1e-2", "--device", "cpu"])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(calls) == 3 and len(hist) == 3
    assert all(np.isfinite(h["loss"]) for h in hist) and np.isfinite(final["final_loss"])
