"""The port's learning-rate schedules against the JAX package's, on the
CPU: every scheduler in both warm-up modes (and without a warm-up),
called at num_update 0..40 in order and then at a few counts out of
order (``FactorScheduler`` and ``MultiFactorScheduler`` keep state that
moves only forward), equal as Python floats.
"""
import pytest

from incubator_mxnet_tpu.optimizer import lr_scheduler as jax_sched

from incubator_mxnet_tpu_torch.optimizer import lr_scheduler as port_sched

SCHEDULERS = [
    ("factor", "FactorScheduler", dict(step=4, factor=0.8,
                                       stop_factor_lr=2e-3, base_lr=0.02)),
    ("multifactor", "MultiFactorScheduler", dict(step=[6, 13, 13, 30],
                                                 factor=0.5, base_lr=0.1)),
    ("poly", "PolyScheduler", dict(max_update=35, base_lr=0.3, pwr=2,
                                   final_lr=1e-3)),
    ("poly_linear", "PolyScheduler", dict(max_update=20, base_lr=1e-4,
                                          pwr=1)),
    ("cosine", "CosineScheduler", dict(max_update=33, base_lr=0.05,
                                       final_lr=1e-4)),
]
WARMUPS = {
    "none": {},
    "linear": dict(warmup_steps=5, warmup_begin_lr=1e-3,
                   warmup_mode="linear"),
    "constant": dict(warmup_steps=5, warmup_mode="constant"),
}
COUNTS = list(range(41)) + [3, 17, 12, 40, 0, 41, 100]


@pytest.mark.parametrize("warmup", list(WARMUPS))
@pytest.mark.parametrize("case,cls,kw", SCHEDULERS,
                         ids=[c for c, _, _ in SCHEDULERS])
def test_scheduler_matches_jax(case, cls, kw, warmup):
    kw = dict(kw, **WARMUPS[warmup])
    port = getattr(port_sched, cls)(**kw)
    ref = getattr(jax_sched, cls)(**kw)
    got = [port(n) for n in COUNTS]
    want = [ref(n) for n in COUNTS]
    assert all(type(g) is float for g in got), got
    assert got == want
    assert vars(port) == vars(ref)          # the state each call moved
    if warmup == "linear":
        assert got[0] == 1e-3 and got[1] != got[0]


def test_base_scheduler_warmup_and_call_match_jax():
    for mode in ("linear", "constant"):
        port = port_sched.LRScheduler(0.4, 8, 0.1, mode)
        ref = jax_sched.LRScheduler(0.4, 8, 0.1, mode)
        assert [port.get_warmup_lr(n) for n in range(10)] == \
            [ref.get_warmup_lr(n) for n in range(10)]
    with pytest.raises(NotImplementedError):
        port_sched.LRScheduler()(1)
