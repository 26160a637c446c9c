"""The port's TransformerLM against the JAX package's, on the CPU.

Weights come from the JAX model's ``init(PRNGKey(0))`` and are carried
across with ``convert.transformer_params_from_jax``; tokens come from
numpy.  The JAX model computes its RMSNorms and its attention softmax
inline in XLA; the port computes the same functions through its ops
(the kernels' plain versions here) and the loss through the softmax
cross-entropy Function.

Tolerances.  float32 (the example's ``--smoke`` config): logits atol
1e-5, loss 1e-5 relative, every gradient max|d| <= 1e-4 · max|g| of its
tensor (float32 sums in another order), the parameters after one SGD
step rtol 1e-6 plus 1e-4 · lr · max|g|.  bfloat16: the two packages round
at other places (the JAX model rounds x·rrms to bf16 before multiplying
by gamma and computes GELU in bf16 steps; the port's RMSNorm rounds once
and its GELU rounds once), so each is as far from the exact result as
bf16 rounding takes it.  The test measures that distance on the JAX side
— the JAX model in bfloat16 against the same (bf16-valued) weights in
float32 — and holds the port's logits and each gradient to twice it
(port and JAX each within it of the exact result); the loss, a mean of
logsumexp(x) − x[target], moves by at most twice the logits' largest
move; each parameter after one SGD step is within one bf16 ulp of the
value plus lr times the two gradients' difference there (the float32
updates differ by that, and rounding to bf16 may land on a neighbouring
value).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.models import transformer as jax_tf

from incubator_mxnet_tpu_torch.convert import (transformer_params_from_jax,
                                               transformer_params_to_numpy)
from incubator_mxnet_tpu_torch.examples import train_transformer_lm
from incubator_mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                          TransformerLM)
from incubator_mxnet_tpu_torch.ops import rms_norm as rn
from incubator_mxnet_tpu_torch.ops import softmax as sm

SMOKE = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_len=64)
LR = 1e-3


def _tree_np(tree):
    """A JAX pytree of arrays → ``{name: float32 numpy}`` with the port's
    names (``layers.wqkv``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv.astype(jnp.float32))
                        for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v.astype(jnp.float32))
    return out


def _flat(nested):
    out = {}
    for k, v in nested.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _tokens(batch, seq, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(
        np.int32)


def _port(cfg_kwargs, params):
    model = TransformerLM(TransformerConfig(**cfg_kwargs)).init(device="cpu")
    transformer_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                model)
    return model


def _jax_run(cfg_kwargs, params, tokens):
    """The JAX model's logits, loss, gradients and SGD update."""
    model = jax_tf.TransformerLM(jax_tf.TransformerConfig(**cfg_kwargs))
    jt = jnp.asarray(tokens)
    loss, grads = jax.value_and_grad(model.loss_fn)(params, jt)
    new = jax.tree_util.tree_map(
        lambda p, g: (p.astype(jnp.float32)
                      - LR * g.astype(jnp.float32)).astype(p.dtype),
        params, grads)
    logits = model.apply(params, jt[:, :-1])
    return dict(logits=np.asarray(logits.astype(jnp.float32)),
                loss=float(loss), grads=_tree_np(grads),
                after=_tree_np(new))


def _port_run(model, tokens):
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        logits = model(tt[:, :-1]).float().numpy()
    params = list(model.parameters())
    loss = model.loss(tt)
    grads = torch.autograd.grad(loss, params)
    names = [n for n, _ in model.named_parameters()]
    out = dict(logits=logits, loss=float(loss),
               grads={n: g.float().numpy() for n, g in zip(names, grads)})
    step_loss = model.make_train_step(lr=LR)(tt)
    assert float(step_loss) == out["loss"]
    out["after"] = _flat(transformer_params_to_numpy(model))
    return out


@pytest.fixture(scope="module")
def smoke_params():
    return {dt: jax_tf.TransformerLM(jax_tf.TransformerConfig(
        **SMOKE, dtype=dt)).init(jax.random.PRNGKey(0))
        for dt in ("float32", "bfloat16")}


def test_weights_carry_across_one_for_one(smoke_params):
    params = smoke_params["bfloat16"]
    model = _port(dict(SMOKE, dtype="bfloat16"), params)
    back = _flat(transformer_params_to_numpy(model))
    want = _tree_np(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.layers["wqkv"].shape == (2, 64, 192)


def test_float32_step_matches_jax(smoke_params):
    params = smoke_params["float32"]
    tokens = _tokens(8, 33, 256)
    want = _jax_run(dict(SMOKE, dtype="float32"), params, tokens)
    model = _port(dict(SMOKE, dtype="float32"), params)
    before = (sm.fwd_launches, sm.bwd_launches, rn.fwd_launches,
              rn.bwd_launches)
    got = _port_run(model, tokens)
    assert before == (sm.fwd_launches, sm.bwd_launches, rn.fwd_launches,
                      rn.bwd_launches)          # CPU: the plain versions
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=1e-5)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        scale = np.abs(g).max()
        assert scale > 0, k
        assert np.abs(got["grads"][k] - g).max() <= 1e-4 * scale, k
        np.testing.assert_allclose(got["after"][k], want["after"][k],
                                   rtol=1e-6, atol=1e-4 * LR * scale,
                                   err_msg=k)


def test_bfloat16_step_matches_jax(smoke_params):
    params = smoke_params["bfloat16"]
    tokens = _tokens(8, 33, 256, seed=1)
    want = _jax_run(dict(SMOKE, dtype="bfloat16"), params, tokens)
    exact = _jax_run(dict(SMOKE, dtype="float32"), jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), params), tokens)
    got = _port_run(_port(dict(SMOKE, dtype="bfloat16"), params), tokens)

    def dist(a, b):
        return np.abs(a - b).max()

    noise = dist(want["logits"], exact["logits"])
    d_logits = dist(got["logits"], want["logits"])
    assert 0 < noise and d_logits <= 2 * noise, (d_logits, noise)
    assert abs(got["loss"] - want["loss"]) <= 2 * d_logits
    for k, g in want["grads"].items():
        noise = dist(g, exact["grads"][k])
        assert dist(got["grads"][k], g) <= 2 * noise, (k, noise)
        w = want["after"][k]
        bound = (np.ldexp(1.0, np.frexp(np.abs(w))[1] - 8)
                 + LR * np.abs(got["grads"][k] - g))
        assert np.all(np.abs(got["after"][k] - w) <= bound), k


def test_default_config_forward_and_loss():
    """The default config's widths (vocab 32000, d_model 512, 8 heads, 4
    layers, d_ff 2048, bfloat16) at B=1, T=33: logits and loss, held as
    the bfloat16 step is."""
    cfg = jax_tf.TransformerConfig()
    params = jax_tf.TransformerLM(cfg).init(jax.random.PRNGKey(0))
    model = jax_tf.TransformerLM(cfg)
    exact_model = jax_tf.TransformerLM(jax_tf.TransformerConfig(
        dtype="float32"))
    tokens = _tokens(1, 33, cfg.vocab_size, seed=2)
    jt = jnp.asarray(tokens)
    want = np.asarray(model.apply(params, jt[:, :-1]).astype(jnp.float32))
    want_loss = float(model.loss_fn(params, jt))
    exact = np.asarray(exact_model.apply(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), params), jt[:, :-1]))
    port = _port({}, params)
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        logits = port(tt[:, :-1])
        loss = float(port.loss(tt))
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 32, 32000)
    got = logits.float().numpy()
    noise = np.abs(want - exact).max()
    d_logits = np.abs(got - want).max()
    assert 0 < noise and d_logits <= 2 * noise, (d_logits, noise)
    assert abs(loss - want_loss) <= 2 * d_logits
    assert abs(loss - np.log(32000)) < 0.5


def test_example_smoke_runs_on_the_cpu():
    losses = train_transformer_lm.main(["--smoke", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert all(abs(v - np.log(256)) < 0.5 for v in losses)


@pytest.mark.parametrize("kwargs", [dict(attention="flash"),
                                    dict(attention="ring"),
                                    dict(use_moe=True)])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        TransformerLM(TransformerConfig(**SMOKE, **kwargs))


@pytest.mark.parametrize("flags", [["--attention", "flash"],
                                   ["--attention", "ring"], ["--dp", "2"],
                                   ["--tp", "2"], ["--pp", "2"],
                                   ["--sp", "2"]])
def test_example_refuses_unported_flags(flags):
    with pytest.raises(NotImplementedError):
        train_transformer_lm.main(["--smoke", "--device", "cpu", *flags])


def test_a_mesh_raises():
    model = TransformerLM(TransformerConfig(**SMOKE)).init(device="cpu")
    tokens = torch.zeros(1, 5, dtype=torch.int64)
    mesh = object()
    for call in (lambda: model(tokens, mesh=mesh),
                 lambda: model.loss(tokens, mesh=mesh),
                 lambda: model.make_train_step(mesh=mesh),
                 lambda: model.apply_pipelined(tokens, mesh, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            call()


def test_loading_needs_initialised_parameters(smoke_params):
    with pytest.raises(ValueError, match="init"):
        transformer_params_from_jax(
            jax.tree_util.tree_map(np.asarray, smoke_params["float32"]),
            TransformerLM(TransformerConfig(**SMOKE, dtype="float32")))
