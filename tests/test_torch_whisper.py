"""Port parity: whisper's encoder-decoder (``repro_torch.models.whisper``)
and its layers (``layernorm``, the GELU MLP) against
``repro.models.whisper``.

Weights come from the reference's ``init_params`` and cross with
``params_from_reference``; frame embeddings and tokens are made with numpy
from a seed.  Held, in f32 compute: the layers at atol = rtol = 1e-5;
``encode``, ``decode``, cached ``decode_step`` and ``loss_fn`` (the loss
at rtol 1e-5, each gradient leaf within 1e-4 of the model's largest |g|
plus 1e-4 of its own) at the whole-model 1e-4 on whisper-base
``reduced()``; cached decode within 2e-3 of the full decode (the
reference's bound), also on
``tests/test_decode_consistency.py::test_whisper_decode_matches_full``'s
config, whose tied head's padded columns are −1e30.  The launchers refuse
the encoder-decoder with the reference's words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import torch_arch_parity as arch  # noqa: E402
from torch_arch_parity import one_thread  # noqa: E402,F401
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import whisper as j_w  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import whisper as t_w  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

ATOL = RTOL = 1e-5
LOGIT_TOL = 1e-4
DECODE_VS_FULL = 2e-3  # tests/test_decode_consistency.py

#: tests/test_decode_consistency.py::test_whisper_decode_matches_full, with a
#: vocabulary off 256 so the head pads (128 → 256 would not)
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=100,
             head_dim=16, is_encoder_decoder=True, num_encoder_layers=2, encoder_seq_len=8,
             compute_dtype="float32")


def test_layernorm_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.normal(size=(2, 5, 16))).astype(np.float32)
    ln = {"scale": rng.normal(size=16).astype(np.float32),
          "bias": rng.normal(size=16).astype(np.float32)}
    want = j_layers.layernorm(jax.tree.map(jnp.asarray, ln), jnp.asarray(x))
    got = t_layers.layernorm({k: torch.from_numpy(v) for k, v in ln.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    jp = j_layers.gelu_mlp_init(jax.random.key(1), 16, 48)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    np.testing.assert_allclose(t_layers.gelu_mlp(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(j_layers.gelu_mlp(jp, jnp.asarray(x))),
                               atol=ATOL, rtol=RTOL)
    init = t_layers.layernorm_init(16, torch.bfloat16)
    assert init["scale"].dtype == torch.bfloat16 and not bool(init["bias"].any())


def _setup(jc, tc, seed=0, B=2, T=8):
    jp = j_w.init_params(jax.random.key(seed), jc)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed + 1)
    frames = rng.normal(size=(B, jc.encoder_seq_len, jc.d_model)).astype(np.float32)
    toks = rng.integers(0, jc.vocab_size, size=(B, T))
    return jp, tp, frames, toks


@pytest.fixture(scope="module")
def model():
    """Both packages' encode, decode, cached decode steps and loss with
    gradients on one batch of whisper-base ``reduced()``."""
    jc, tc = j_get_config("whisper-base").reduced(), t_get_config("whisper-base").reduced()
    jp, tp, frames, toks = _setup(jc, tc)
    B, T = toks.shape
    batch = {"frame_embeds": frames, "tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    jmem = jax.jit(lambda p, f: j_w.encode(p, jc, f))(jp, jb["frame_embeds"])
    jfull = jax.jit(lambda p, t, m: j_w.decode(p, jc, t, m)[0])(jp, jb["tokens"], jmem)
    jstep = jax.jit(lambda p, t, m, c, pos: j_w.decode_step(p, jc, t, m, c, position=pos))
    cache, jdec = j_w.init_decoder_cache(jc, B, T, jnp.float32), []
    for t in range(T):
        lg, cache = jstep(jp, jb["tokens"][:, t:t + 1], jmem, cache, t)
        jdec.append(np.asarray(lg[:, 0]))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_w.loss_fn(p, jc, b), has_aux=True))(jp, jb)

    with torch.no_grad():
        tmem = t_w.encode(tp, tc, tb["frame_embeds"])
        tfull = t_w.decode(tp, tc, tb["tokens"], tmem)[0]
        cache, tdec = t_w.init_decoder_cache(tc, B, T, torch.float32), []
        for t in range(T):
            lg, cache = t_w.decode_step(tp, tc, tb["tokens"][:, t:t + 1], tmem, cache, position=t)
            tdec.append(lg[:, 0].numpy())
        assert cache.index == T
    grad_tree = pytree.tree_map(lambda x: x.clone().requires_grad_(True), tp)
    tloss, tmet = t_w.loss_fn(grad_tree, tc, tb)
    tloss.backward()
    return {
        "cfg": tc,
        "jax": {"memory": np.asarray(jmem), "full": np.asarray(jfull), "dec": np.stack(jdec, 1),
                "loss": float(jloss), "metrics": {k: float(v) for k, v in jmet.items()},
                "grads": arch.flat(jgrads)},
        "port": {"memory": tmem.numpy(), "full": tfull.numpy(), "dec": np.stack(tdec, 1),
                 "loss": float(tloss.detach()),
                 "metrics": {k: float(v.detach()) for k, v in tmet.items()},
                 "grads": arch.flat(pytree.tree_map(lambda x: x.grad, grad_tree))},
    }


def test_encode_matches_jax(model):
    j, t = model["jax"], model["port"]
    assert t["memory"].shape == (2, model["cfg"].encoder_seq_len, model["cfg"].d_model)
    np.testing.assert_allclose(t["memory"], j["memory"], atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_decode_matches_jax(model):
    cfg = model["cfg"]
    arch.check_logits(model["port"]["full"], model["jax"]["full"], cfg.vocab_size)
    assert model["port"]["full"].shape[-1] == cfg.padded_vocab


def test_cached_decode_matches_the_full_decode_and_masks_the_padded_vocab():
    """``test_decode_matches_full``'s config on the port (vocabulary 100,
    padded to 256): cached ``decode_step`` within the reference's 2e-3 of
    the full ``decode``, the padded columns −1e30 in both."""
    tc = TConfig(**SMALL)
    tp = t_w.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 100, size=(2, 8)))
    with torch.no_grad():
        mem = t_w.encode(tp, tc, frames)
        full = t_w.decode(tp, tc, toks, mem)[0]
        cache, steps = t_w.init_decoder_cache(tc, 2, 8, torch.float32), []
        for t in range(8):
            lg, cache = t_w.decode_step(tp, tc, toks[:, t:t + 1], mem, cache, position=t)
            steps.append(lg[:, 0])
    dec = torch.stack(steps, 1)
    assert full.shape[-1] == tc.padded_vocab == 256
    assert float((dec - full)[..., :100].abs().max()) < DECODE_VS_FULL
    for lg in (full, dec):
        assert bool((lg[..., 100:] == np.float32(-1e30)).all())


def test_decode_step_matches_jax_and_the_full_decode(model):
    cfg = model["cfg"]
    arch.check_logits(model["port"]["dec"], model["jax"]["dec"], cfg.vocab_size)
    V = cfg.vocab_size
    assert float(np.abs(model["port"]["dec"][..., :V] - model["port"]["full"][..., :V]).max()) \
        < DECODE_VS_FULL


def test_loss_and_grads_match_jax(model):
    assert model["port"]["metrics"].keys() == {"ce"}
    arch.check_train_step(model)


def test_tree_matches_reference():
    """whisper-base at full size on the meta device: every leaf's name, shape
    and type as ``jax.eval_shape(init_params)`` gives them (``wk`` without a
    bias, 4,096 decoder positions, 1,500 encoder positions)."""
    jc, tc = j_get_config("whisper-base"), t_get_config("whisper-base")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    shapes = jax.eval_shape(lambda k: j_w.init_params(k, jc), jax.random.key(0))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
    tp = t_w.init_params(torch.Generator(), tc, device="meta")
    got = {pytree.keystr(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in pytree.tree_leaves_with_path(tp)}
    assert got == want
    assert "bias" not in tp["encoder"]["attn"]["wk"]
    assert got["['dec_pos']"][0] == (4096, 512) and got["['enc_pos']"][0] == (1500, 512)


def test_launchers_refuse_the_encoder_decoder():
    with pytest.raises(SystemExit, match="enc-dec serving: see examples/whisper_serve.py"):
        t_serve.main(["--arch", "whisper-base", "--reduced", "--device", "cpu"])
    with pytest.raises(SystemExit, match="use examples/whisper_train.py for enc-dec training"):
        t_train.main(["--arch", "whisper-base", "--reduced", "--device", "cpu"])
