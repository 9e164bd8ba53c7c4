"""The eager env path's modules against the JAX package's, one by one: the
pump at half-increment boundaries, the noise lattice and Catmull-Rom from
the same normals, a daily meal plan from the same uniforms, the meal
lookups, the patient's minute over meals, and the BB / PID / constant
controllers.

Inputs are made with numpy from a seed, B = 8, and handed to both sides in
the named dtype; the JAX functions (single-env) run under vmap, the port's
are batch-native.  Where JAX draws from threefry, the test draws JAX's own
normals / uniforms and feeds them to the port's arithmetic.  Tolerances:
float64 rtol 1e-12 (the same operations in the same order; libm's last
bits may differ); float32 as tests/test_torch_rollout_exo.py: glucose rtol
2e-6, insulin rtol 1e-6, CHO and the pump's increments exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simglucose_tpu.controllers import functional as jctl
from simglucose_tpu.core import types as jtypes
from simglucose_tpu.devices import pump as jpump
from simglucose_tpu.models import patient as jpatient
from simglucose_tpu.ops import noise as jnoise
from simglucose_tpu.params import (
    load_patient_params,
    load_pump_params,
    load_quest_params,
    load_sensor_params,
)
from simglucose_tpu.scenario import meal as jmeal
from simglucose_tpu_torch.controllers import functional as tctl
from simglucose_tpu_torch.core import types as ttypes
from simglucose_tpu_torch.core.types import from_jax
from simglucose_tpu_torch.devices import pump as tpump
from simglucose_tpu_torch.models import patient as tpatient
from simglucose_tpu_torch.ops import noise as tnoise
from simglucose_tpu_torch.ops.streams import env_keys
from simglucose_tpu_torch.scenario import meal as tmeal

torch.set_num_threads(1)

B = 8
DTYPES = [np.float64, np.float32]
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=2e-6, atol=1e-6)}
NOISE_ATOL = 1e-5  # mg/dL: a few float32 ulps of a 40 mg/dL noise value


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, ref, dtype, err_msg="", atol=None):
    tol = dict(TOL[dtype])
    if atol is not None and dtype == np.float32:
        tol["atol"] = atol
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=err_msg, **tol)


# float32, per patient state: within rtol of the state's largest magnitude
# over the cohort.  State 6, the insulin action X, integrates p2u (I - Ib)
# with I and Ib near 100 pmol/L: it keeps the absolute precision of a
# float32 difference at 100 (an ulp is 7.6e-6), not a relative one of its
# own ~0.1 (measured: 5.5e-5 of its largest magnitude after 30 minutes).
RTOL_STATES = np.full(13, 2e-6)
RTOL_STATES[6] = 1e-4


def _close_columns(got, ref, dtype, err_msg=""):
    """A float32 ``[..., 13]`` patient state held per column to
    RTOL_STATES of the column's largest magnitude (float64: :func:`_close`)."""
    ref = np.asarray(ref)
    if dtype == np.float64 or ref.ndim < 2:
        return _close(got, ref, dtype, err_msg)
    got = got.numpy()
    scale = np.abs(ref).reshape(-1, ref.shape[-1]).max(axis=0)
    bad = np.abs(got - ref) > RTOL_STATES * scale
    assert not bad.any(), f"{err_msg}: {got[bad]} vs {ref[bad]}"


def _boundaries(inc, dtype):
    """Commands whose pmol count lands exactly on k + 1/2 increments in
    ``dtype`` (the pump's own operations, a * 6000 / inc), with their k."""
    cmds, ks = [], []
    for k in range(64):
        a = dtype((k + 0.5) * inc / 6000.0)
        for _ in range(8):
            q = (a * dtype(6000.0)) / dtype(inc)
            if q == k + 0.5:
                cmds.append(a)
                ks.append(k)
                break
            a = np.nextafter(a, dtype(np.inf) if q < k + 0.5 else dtype(-np.inf))
    return np.asarray(cmds, dtype), np.asarray(ks)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["bolus", "basal"])
def test_pump_at_half_increment_boundaries(dtype, which):
    """Commands exactly at k + 1/2 increments (round half to even), one ulp
    on either side, random ones, below the minimum and above the maximum:
    the same doses, exact."""
    pump = jax.tree.map(lambda a: np.asarray(a, dtype), load_pump_params("Insulet", dtype=np.float64))
    inc = float(getattr(pump, f"inc_{which}"))
    at, k = _boundaries(inc, dtype)
    assert len(k) >= 32
    rng = np.random.default_rng(1)
    amounts = np.concatenate([at, np.nextafter(at, dtype(0)), np.nextafter(at, dtype(1)),
                              rng.uniform(0, 0.05, 64).astype(dtype), np.asarray([-1.0, 0.0, 1e3], dtype)])
    jfn, tfn = getattr(jpump, f"pump_{which}"), getattr(tpump, f"pump_{which}")
    ref = np.asarray(jfn(pump, jnp.asarray(amounts)))
    got = tfn(from_jax(pump, device="cpu"), _t(amounts)).numpy()
    np.testing.assert_array_equal(got, ref)
    # the boundaries round half to even: k + 1/2 -> the even one of k, k + 1
    doses = np.round(got[:len(k)].astype(np.float64) * 6000.0 / inc)
    np.testing.assert_array_equal(doses, k + (k % 2))


def _sensor(dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), load_sensor_params("Dexcom", dtype=np.float64))


@pytest.mark.parametrize("dtype", DTYPES)
def test_noise_lattice_from_the_same_normals(dtype):
    """The lattice window at reset from JAX's own three normals, then 40
    samples of the streaming chain (Catmull-Rom between lattice points,
    one advance per 15 min) with each advance's normal fed to both.  In
    float32 the noise values (mg/dL, up to ~40) hold to NOISE_ATOL: sinh
    rounds its last bit its own way on each side."""
    params = _sensor(dtype)
    tparams = from_jax(params, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jinit = jax.vmap(lambda k: jnoise.noise_lattice_init(params, k, dtype=dtype))(keys)
    z = [np.asarray(jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, j), dtype=dtype))(keys))
         for j in range(3)]
    got = tnoise.noise_lattice_from_normals(tparams, *map(_t, z))
    for g, r, name in zip(got, jinit, ("e", "lattice", "seg", "lattice_next")):
        _close(g, r, dtype, name, atol=NOISE_ATOL)
    jstate, tstate = jinit, got
    step = jax.jit(jax.vmap(lambda e, l, s, n, c, k: jnoise.noise_next(params, 3, e, l, s, n, c, k)))
    for c in range(40):
        count = np.full(B, c, np.int32)
        jval, jstate = step(*jstate, jnp.asarray(count), keys)
        znext = np.asarray(jax.vmap(lambda k, n: jax.random.normal(jax.random.fold_in(k, n), dtype=dtype))(
            keys, jnp.asarray(np.asarray(tstate[3]))))
        tval, tstate = tnoise.noise_advance(tparams, 3, *tstate, _t(count), _t(znext))
        _close(tval, jval, dtype, f"sample {c}", atol=NOISE_ATOL)
        for g, r, name in zip(tstate, jstate, ("e", "lattice", "seg", "lattice_next")):
            _close(g, r, dtype, f"{name} after sample {c}", atol=NOISE_ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_catmull_rom_matches_jax(dtype):
    rng = np.random.default_rng(2)
    lattice = rng.normal(0, 10, (B, 4)).astype(dtype)
    u = rng.uniform(0, 1, B).astype(dtype)
    _close(tnoise._catmull_rom(_t(lattice), _t(u)), jnoise._catmull_rom(jnp.asarray(lattice), jnp.asarray(u)),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_daily_plan_from_the_same_uniforms(dtype):
    """create_daily_plan of JAX's own 18 uniforms per plan, 64 plans: the
    same meal minutes and grams (rounded: exact)."""
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (18,), dtype=dtype,
                                                         minval=jnp.finfo(dtype).tiny))(keys))
    jt, ja = jax.vmap(lambda k: jmeal.create_daily_plan(k, dtype=dtype))(keys)
    tt, ta = tmeal.create_daily_plan(_t(u))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (tt.numpy() >= 0).mean() > 0.5


@pytest.mark.parametrize("dtype", DTYPES)
def test_meal_lookups_match_jax(dtype):
    """The random scenario's step lookup across a midnight (a plan carried
    from JAX, the next day's drawn by each side from its own stream: only
    the minutes before midnight are compared) and the custom scenario's."""
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    start = np.array([0, 300, 420, 719, 1437, 1438, 1439, 600], np.int32)
    jstate = jax.vmap(lambda k, s: jmeal.scenario_init(k, s, dtype=dtype))(keys, jnp.asarray(start))
    # place a meal on each lane's first minute, to see the lookup hit
    times = np.asarray(jstate.meal_times).copy()
    times[:, 0] = start % 1440
    jstate = jstate._replace(meal_times=jnp.asarray(times))
    tstate = from_jax(jstate, device="cpu", key=env_keys(0, B, device="cpu"))
    t0 = np.zeros(B, np.int32)
    jstate2, jmeals = jax.vmap(lambda s, t: jmeal.scenario_meals_for_step(s, t, 3, dtype=dtype))(
        jstate, jnp.asarray(t0))
    tstate2, tmeals = tmeal.scenario_meals_for_step(tstate, _t(t0), 3, dtype=ttypes_dtype(dtype))
    mins = start[:, None] + np.arange(3)
    before = mins < 1440
    np.testing.assert_array_equal(tmeals.numpy()[before], np.asarray(jmeals)[before])
    np.testing.assert_array_equal(tstate2.day.numpy(), np.asarray(jstate2.day))
    assert (tmeals.numpy()[:, 0] > 0).sum() >= 5
    look_j = jax.vmap(lambda s, t: jmeal.scenario_lookup_for_step(s, t, 3))(jstate, jnp.asarray(t0))
    np.testing.assert_array_equal(tmeal.scenario_lookup_for_step(tstate, _t(t0), 3).numpy(),
                                  np.asarray(look_j))
    # catching up to the clock: the same days redraw (each side from its own
    # stream), the others keep their plan
    t_now = np.full(B, 3, np.int32)
    jcaught = jax.vmap(lambda s, t: jmeal.scenario_regen_now(s, t, dtype=dtype))(jstate, jnp.asarray(t_now))
    tcaught = tmeal.scenario_regen_now(tstate, _t(t_now), dtype=ttypes_dtype(dtype))
    np.testing.assert_array_equal(tcaught.day.numpy(), np.asarray(jcaught.day))
    kept = tcaught.day.numpy() == tstate.day.numpy()
    assert 0 < kept.sum() < B
    np.testing.assert_array_equal(tcaught.meal_times.numpy()[kept], np.asarray(jcaught.meal_times)[kept])

    ctimes = np.array([[0, 4, 4, 7]] * B, np.int32)
    camts = np.array([[10.0, 20.0, 30.0, 40.0]] * B, dtype)
    for t in (0, 3, 6, 9):
        tt = np.full(B, t, np.int32)
        ref = jax.vmap(lambda a, b, c: jmeal.custom_meals_for_step(a, b, c, 3))(
            jnp.asarray(ctimes), jnp.asarray(camts), jnp.asarray(tt))
        got = tmeal.custom_meals_for_step(_t(ctimes), _t(camts), _t(tt), 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def ttypes_dtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _patient_inputs(dtype, seed=0):
    names = list(range(1, B + 1))
    params = jax.tree.map(lambda a: np.asarray(a, dtype), load_patient_params(names, dtype=np.float64))
    return params


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("rk45", 2)])
def test_patient_step_over_meals(dtype, method, substeps):
    """30 minutes from x0 with meals announced at minutes 2 and 9 (a second
    meal while the first is queued) and a varying insulin rate: every
    field of the patient state after every minute (float32: each ODE state
    to RTOL_STATES of its largest magnitude, :func:`_close_columns`)."""
    params = _patient_inputs(dtype)
    tparams = from_jax(params, device="cpu")
    rng = np.random.default_rng(7)
    cho = np.zeros((30, B), dtype)
    cho[2] = rng.uniform(20, 80, B)
    cho[9] = rng.uniform(5, 30, B)
    ins = rng.uniform(0, 0.1, (30, B)).astype(dtype)
    jstate = jax.vmap(lambda p: jpatient.patient_init(p, dtype=dtype))(params)
    tstate = tpatient.patient_init(tparams, dtype=ttypes_dtype(dtype))
    for f in jtypes.PatientState._fields:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f)
    step = jax.jit(jax.vmap(lambda s, p, a: jpatient.patient_step(s, p, a, substeps=substeps, method=method)))
    for m in range(30):
        jstate = step(jstate, params, jtypes.PatientAction(CHO=jnp.asarray(cho[m]), insulin=jnp.asarray(ins[m])))
        tstate = tpatient.patient_step(tstate, tparams, ttypes.PatientAction(CHO=_t(cho[m]), insulin=_t(ins[m])),
                                       substeps=substeps, method=method)
        for f in jtypes.PatientState._fields:
            _close_columns(getattr(tstate, f), getattr(jstate, f), dtype, f"{f} minute {m}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_patient_init_random_bg_from_the_same_normals(dtype):
    params = _patient_inputs(dtype)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    jstate = jax.vmap(lambda p, k: jpatient.patient_init(p, key=k, random_init_bg=True, dtype=dtype))(params, keys)
    z = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,), dtype=dtype))(keys))
    tstate = tpatient.patient_init(from_jax(params, device="cpu"), random_init_bg=True,
                                   dtype=ttypes_dtype(dtype), z=_t(z))
    _close(tstate.x, jstate.x, dtype)
    _close(tstate.last_Qsto, jstate.last_Qsto, dtype)


def _results(dtype, seed):
    rng = np.random.default_rng(seed)
    cgm = rng.uniform(60, 300, B).astype(dtype)
    cho = np.where(rng.random(B) < 0.5, rng.uniform(0, 15, B), 0.0).astype(dtype)
    z = np.zeros(B, dtype)
    fields = dict(reward=z, done=np.zeros(B, bool), CHO=cho, insulin=z, BG=cgm, CGM=cgm, LBGI=z, HBGI=z,
                  risk=z)
    j = jtypes.StepResult(observation=jtypes.Observation(CGM=jnp.asarray(cgm)),
                          **{k: jnp.asarray(v) for k, v in fields.items()})
    return j, from_jax(j, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_controllers_match_jax(dtype):
    """BB (closed over and state-carried), PID (10 steps of state) and the
    constant basal, on the same previous-step results."""
    names = list(range(1, B + 1))
    patient = jax.tree.map(lambda a: np.asarray(a, dtype), load_patient_params(names, dtype=np.float64))
    quest = jax.tree.map(lambda a: np.asarray(a, dtype), load_quest_params(names, dtype=np.float64))
    jbb = jctl.bb_params(patient, quest)
    tbb = tctl.bb_params(from_jax(patient, device="cpu"), from_jax(quest, device="cpu"))
    for f in jctl.BBParams._fields:
        _close(getattr(tbb, f), getattr(jbb, f), dtype, f)
    jres, tres = _results(dtype, 9)
    jact = jax.vmap(lambda b, r: jctl.bb_policy(3, target=130.0)(b, r)[1])(jbb, jres)
    tact = tctl.bb_policy(3, target=130.0)(tbb, tres)[1]
    _, tact2 = tctl.bb_controller(tbb, 3, target=130.0)[1]((), tres)
    for f in ("basal", "bolus"):
        _close(getattr(tact, f), getattr(jact, f), dtype, f)
        np.testing.assert_array_equal(getattr(tact2, f).numpy(), getattr(tact, f).numpy())
    assert (tact.bolus.numpy() > 0).sum() >= 2

    jinit, jpid = jctl.pid_controller(3, P=-1e-4, I=-1e-7, D=-2e-3, dtype=dtype)
    tinit, tpid = tctl.pid_controller(3, P=-1e-4, I=-1e-7, D=-2e-3, dtype=ttypes_dtype(dtype), device="cpu")
    jstate = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,)), jinit)
    tstate = tinit
    for s in range(10):
        jres, tres = _results(dtype, 10 + s)
        jstate, jact = jax.vmap(jpid)(jstate, jres)
        tstate, tact = tpid(tstate, tres)
        for f in ("basal", "bolus"):
            _close(getattr(tact, f), getattr(jact, f), dtype, f"pid {f} step {s}")
        _close(tstate.integrated, jstate.integrated, dtype, f"integrated step {s}")

    _, jconst = jctl.constant_controller(0.02, dtype=dtype)
    _, tconst = tctl.constant_controller(0.02, dtype=ttypes_dtype(dtype), device="cpu")
    jact, tact = jconst((), jres)[1], tconst((), tres)[1]
    for f in ("basal", "bolus"):
        np.testing.assert_array_equal(getattr(tact, f).numpy(), np.asarray(getattr(jact, f)))
