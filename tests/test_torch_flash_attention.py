"""The port's training attention on the CPU: the plain version and the
autograd Function (whose forward and backward are the CUDA kernels'
arithmetic in eager ops on CPU tensors) against the JAX package's
flash_attention_padmask, run through the stock Pallas kernel in interpret
mode; a float64 gradcheck of the Function; the padding contract; dispatch.
The CUDA kernels themselves are held against the plain version on the card
by chip_smoke.py."""

import numpy as np
import pytest
import torch

from tts_king_torch.ops.kernels import flash_attention as fa


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    lens = rng.randint(max(T // 2, 1), T + 1, size=(B,))
    mask = np.arange(T)[None] >= lens[:, None]
    valid = np.arange(T)[None, None, :, None] < lens[:, None, None, None]
    return q, k, v, mask, valid


def _torch_grads(fn, q, k, v, mask, valid):
    """fn's output and the gradients of sum((out * valid)^2), as the JAX
    test takes them: padded query rows get no upstream gradient."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(qt, kt, vt, torch.from_numpy(mask))
    loss = ((out * torch.from_numpy(valid.astype(np.float32))) ** 2).sum()
    grads = torch.autograd.grad(loss, (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.fixture(scope="module", params=[(2, 2, 100, 32), (1, 2, 256, 128),
                                        (3, 1, 50, 16)],
                ids=lambda s: "x".join(map(str, s)))
def jax_flash(request):
    """Inputs and JAX's flash_attention_padmask output and gradients, the
    stock Pallas TPU kernel in interpret mode (tests/test_flash_attention)."""
    import jax
    import jax.experimental.pallas.tpu as pltpu
    import jax.numpy as jnp

    from tts_king_tpu.ops.pallas.attention import flash_attention_padmask

    B, H, T, D = request.param
    q, k, v, mask, valid = _inputs(B, H, T, D, seed=B * 100 + T)
    jm, jv = jnp.asarray(mask), jnp.asarray(valid)

    def loss(q, k, v):
        return jnp.sum((flash_attention_padmask(q, k, v, jm) * jv) ** 2)

    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(flash_attention_padmask(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))
        grads = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    return (q, k, v, mask, valid), out, grads


@pytest.mark.parametrize("fn", ["plain", "function"])
def test_flash_matches_jax_flash_attention_padmask(jax_flash, fn):
    """Forward at rtol 1e-4 / atol 1e-5 on the valid rows and dq/dk/dv at
    rtol 1e-3 / atol 1e-4 (the JAX package's own flash test's bounds: f32
    sums in another order, and an online softmax on the JAX side)."""
    (q, k, v, mask, valid), ref, ref_grads = jax_flash
    f = fa.flash_attention_plain if fn == "plain" else fa.FlashAttention.apply
    got, grads = _torch_grads(f, q, k, v, mask, valid)
    np.testing.assert_allclose(np.where(valid, got, 0),
                               np.where(valid, ref, 0), rtol=1e-4, atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4, err_msg=name)


def test_function_gradcheck_float64():
    """The hand-written backward (recomputed P from the log-sum-exp, Delta,
    dS) against finite differences, with padded keys and query rows."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, 9, 4)).requires_grad_(True)
               for _ in range(3))
    mask = torch.from_numpy(np.arange(9)[None] >= 6)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttention.apply(q, k, v, mask), (q, k, v))


def test_function_matches_plain_autograd_and_zeroes_padded_keys():
    """The Function's backward equals autograd through the plain version,
    and dK, dV are exactly 0 at padded keys (P is 0 there)."""
    q, k, v, mask, valid = _inputs(2, 2, 37, 8, seed=5)
    out_f, g_f = _torch_grads(fa.FlashAttention.apply, q, k, v, mask, valid)
    out_p, g_p = _torch_grads(fa.flash_attention_plain, q, k, v, mask, valid)
    np.testing.assert_allclose(out_f, out_p, rtol=1e-5, atol=1e-6)
    for g, r in zip(g_f, g_p):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
    pad = np.broadcast_to(mask[:, None, :, None], g_f[1].shape)
    assert pad.any()
    assert not g_f[1][pad].any() and not g_f[2][pad].any()
    # padded query rows attend the valid keys: finite, not zero
    padded_rows = np.broadcast_to(~valid, out_f.shape)
    assert np.isfinite(out_f).all() and np.abs(out_f[padded_rows]).max() > 0


def test_forward_plain_returns_the_log_sum_exp():
    q, k, v, mask, _ = _inputs(2, 2, 20, 8, seed=1)
    qt, kt, vt, mt = (torch.from_numpy(a) for a in (q, k, v, mask))
    o, lse = fa.flash_forward_plain(qt, kt, vt, mt)
    s = fa._scores(qt, kt, mt)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        o.numpy(), fa.flash_attention_plain(qt, kt, vt, mt).numpy(),
        rtol=1e-5, atol=1e-6)


def test_dispatch_and_contract():
    """CPU tensors take the plain version and launch nothing; other devices
    raise; bf16 raises TypeError until a PR needs it; shapes are checked."""
    q, k, v, mask, _ = _inputs(1, 2, 10, 8, seed=2)
    qt, kt, vt, mt = (torch.from_numpy(a) for a in (q, k, v, mask))
    before = (fa.launches_fwd, fa.launches_bwd)
    out = fa.flash_attention(qt.requires_grad_(), kt, vt, mt)
    out.sum().backward()
    assert (fa.launches_fwd, fa.launches_bwd) == before
    np.testing.assert_array_equal(
        out.detach().numpy(),
        fa.flash_attention_plain(qt, kt, vt, mt).detach().numpy())
    with pytest.raises(TypeError):
        fa.flash_attention(qt.detach().bfloat16(), kt.bfloat16(),
                           vt.bfloat16(), mt)
    with pytest.raises(ValueError):
        fa.flash_attention(qt.detach().to("meta"), kt.to("meta"),
                           vt.to("meta"), mt.to("meta"))
    with pytest.raises(ValueError):
        fa.flash_attention(qt.detach(), kt, vt, mt[:, :5])
