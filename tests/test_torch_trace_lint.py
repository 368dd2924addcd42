"""The port's trace rules (``repro_torch.analysis.trace_lint``).

* RECOMPILE, CPU half: the slab draw, driven as the reference's check
  drives its own (128 rows, batch 8, slab 2, three states, keys from
  ``sample_key``, beta at 0.4 + 0.1 d), has one op signature for the
  annealed-beta draws and two with the beta=None draws; a seeded
  signature churn (a shape change, a Python scalar in an op, a dtype
  flip, a slab draw that threads beta as a float) is caught, the
  counterpart of ``tests/test_analysis.py::test_trace_cache_counter_sees_
  signature_churn``.
* RECOMPILE, card half: without CUDA it returns its reason as a skip,
  and on the CPU the runner records no capture (``chip_smoke.py``'s
  ``analysis`` phase holds it at one capture on the card).
* DTYPE-WIDE: the four samplers are clean; the reference-dtype table is
  the reference's own samplers' output and state dtypes; a seeded
  float64 op and a seeded int64 output are flagged, the counterpart of
  ``tests/test_analysis.py::test_dtype_scan_flags_wide_and_weak``; int64
  inside a call and float64 under ``xla_float.py`` are not.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.samplers import make_sampler as ref_make_sampler
from repro_torch import prng
from repro_torch.analysis import trace_lint as tl
from repro_torch.xla_float import fma32

KINDS = ("per-cumsum", "per-sumtree", "amper-fr", "amper-k")


def test_slab_draw_has_one_signature_and_two_with_beta_none():
    sample, calls, none_calls = tl._slab_calls()
    assert tl.distinct_signatures(sample, calls) == 1
    assert tl.distinct_signatures(sample, calls + none_calls) == 2
    assert tl.check_recompile() == []


@pytest.mark.parametrize("case", ["shape", "python-scalar", "dtype"])
def test_signature_counter_sees_churn(case):
    x = torch.zeros(2)
    fn, calls, steady = {
        "shape": (lambda a: a + 1, [(torch.zeros(2),), (torch.zeros(3),)],
                  [(torch.zeros(2),), (torch.ones(2),)]),
        "python-scalar": (lambda a, b: a * b, [(x, 0.4), (x, 0.5)],
                          [(x, torch.tensor(0.4)), (x, torch.tensor(0.5))]),
        "dtype": (lambda a: a * 2, [(torch.zeros(2),),
                                    (torch.zeros(2, dtype=torch.float64),)],
                  [(torch.zeros(2),), (torch.full((2,), 3.0),)]),
    }[case]
    assert tl.distinct_signatures(fn, calls) == 2
    assert tl.distinct_signatures(fn, steady) == 1  # values are data


def test_seeded_slab_churn_is_a_recompile_finding(monkeypatch):
    """A slab draw that threads beta into an op as a Python float: one
    signature a beta value, which the rule reports."""
    sample, calls, none_calls = tl._slab_calls()

    def churning(state, key, beta):
        out = sample(state, key, beta)
        return out[2] * (0.4 if beta is None else float(beta))

    monkeypatch.setattr(tl, "_slab_calls",
                        lambda: (churning, calls, none_calls))
    findings = tl.check_recompile()
    assert [f.rule for f in findings] == ["RECOMPILE", "RECOMPILE"]
    assert "3 signatures for 3" in findings[0].message


def test_card_half_skips_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py's analysis phase "
                    "runs the card half")
    findings, counts, skipped = tl.check_recapture()
    assert findings == [] and counts == {} and "CUDA" in skipped
    extra = {}
    tl.run_trace_checks(recapture=extra)
    assert "CUDA" in extra["skipped"]


def test_cpu_runner_counts_no_capture():
    """On the CPU the runner runs the graph's body itself: no capture is
    counted, however many steady steps ran."""
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(sampler="amper-fr", amper_fr_mode="fused", num_envs=2,
                    replay_size=256, batch=16, hidden=16, learn_start=4,
                    target_sync=100)
    dqn = make_dqn(cfg, device="cpu")
    runner = dqn.runner(dqn.init(prng.key(0)), prng.key(0), 12, capture=True)
    runner.advance(8)
    runner.advance(12)
    assert runner.info["captures"] == 0 and not runner.info["captured"]


@pytest.mark.parametrize("kind", KINDS)
def test_dtype_wide_clean_on_registry_sampler(kind):
    exempt = {}
    assert tl.check_dtype_promotion(kinds=(kind,), exempt=exempt) == []
    # the uniform draw (and AMPER's representatives) go through fma32
    assert exempt[f"{kind}.sample"] > 0 and exempt[f"{kind}.update"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_reference_dtype_table_is_the_references(kind):
    """Each public output and state leaf's dtype in ``REFERENCE_DTYPES``
    is the reference sampler's, read from its abstract evaluation."""
    s = ref_make_sampler(kind, 256)
    st = s.update(s.init(), jnp.arange(256), jnp.ones(256))
    new = jax.eval_shape(s.update, st, jnp.arange(16, dtype=jnp.int32),
                         jnp.linspace(0.1, 1.0, 16))
    want = {name: getattr(new, name).dtype for name in new._fields}
    with jax.threefry_partitionable(True):
        want["indices"] = jax.eval_shape(
            lambda a, k: s.sample(a, k, 16), st, jax.random.key(0)).dtype
    want["total"] = jax.eval_shape(s.total, st).dtype
    want["priorities"] = jax.eval_shape(s.priorities, st).dtype
    for name, dt in want.items():
        got = tl.REFERENCE_DTYPES[name]
        assert str(got).removeprefix("torch.") == str(dt), name


def test_seeded_float64_op_is_flagged():
    _, rec = tl.record(lambda x: torch.cumsum(x * 2.0, 0),
                       torch.arange(4, dtype=torch.float64))
    wide = tl.scan_dtypes(rec, "x64-fixture")
    assert {f.rule for f in wide} == {"DTYPE-WIDE"}
    assert any("float64" in f.message and "cumsum" in f.message
               for f in wide)
    _, rec = tl.record(lambda z: torch.view_as_complex(z.double()) * 2,
                       torch.zeros(2, 2))
    assert any("complex128" in f.message for f in tl.scan_dtypes(rec, "c"))


def test_seeded_int64_output_is_flagged_and_int64_inside_is_not():
    rows = torch.arange(16)  # int64: wider than the reference's int32
    wide = tl.check_leaves({"indices": rows, "valid": rows > 3,
                            "pq": rows.to(torch.int32)}, "i64-fixture")
    assert [f.message for f in wide] == [
        "leaf 'indices' of i64-fixture is torch.int64, wider than the "
        "reference's torch.int32"]
    assert tl.check_leaves({"weights": rows.to(torch.float64)}, "w")
    assert tl.check_leaves({"mystery": rows}, "u")  # not in the table
    # int64 inside a call: the index dtype, not flagged
    _, rec = tl.record(lambda x: (x.long() * 3).to(torch.int32),
                       torch.arange(4, dtype=torch.int32))
    assert tl.scan_dtypes(rec, "idx") == []


def test_float64_under_xla_float_is_counted_not_flagged():
    a, b = torch.full((3,), 1.5), torch.full((3,), 2.0)
    out, rec = tl.record(fma32, a, b, 0.25)
    assert out.dtype == torch.float32 and rec.exempt > 0
    assert tl.scan_dtypes(rec, "fma32") == []
    _, rec = tl.record(lambda x: (x.double() * 2).float(), a)
    assert rec.exempt == 0 and tl.scan_dtypes(rec, "not exempt")
