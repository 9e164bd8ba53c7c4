"""The port's rllab ``Step`` shim (reference: simulation/env.py:9-20), as
tests/test_rllab_compat.py holds the JAX package's."""
import torch

from simglucose_tpu_torch.core.types import CtrlAction, Observation
from simglucose_tpu_torch.envs import Step, step_result_to_rllab
from simglucose_tpu_torch.envs.build import make_env
from simglucose_tpu_torch.envs.functional import env_reset, env_step
from simglucose_tpu_torch.ops.streams import env_keys

torch.set_num_threads(1)


def test_step_tuple_contract():
    s = Step(observation=1.0, reward=-0.5, done=False, bg=140.0, risk=1.2)
    assert s.observation == 1.0
    assert s.reward == -0.5
    assert s.done is False
    assert s.info == {"bg": 140.0, "risk": 1.2}
    # namedtuple unpacking, like rllab consumers do
    obs, rew, done, info = s
    assert info["bg"] == 140.0


def test_step_result_converter():
    """A single env's reset and step results: each tensor field a Python
    float (done a bool)."""
    cfg, params = make_env("adolescent#001", device="cpu")
    state, res = env_reset(cfg, params, env_keys(0, 1, device="cpu")[0])
    s = step_result_to_rllab(res, sample_time=cfg.sample_time, patient_name="adolescent#001")
    assert s.done is False and s.reward == 0.0
    assert s.info["sample_time"] == cfg.sample_time
    assert 100.0 < s.info["bg"] < 200.0
    assert s.info["risk"] == float(res.risk)
    assert s.observation == Observation(CGM=float(res.observation.CGM))
    basal = torch.tensor(0.01)
    _, res = env_step(cfg, params, state, CtrlAction(basal=basal, bolus=torch.zeros(())))
    s = step_result_to_rllab(res, patient_state=state.patient.x)
    for k in ("meal", "bg", "lbgi", "hbgi", "risk"):
        assert type(s.info[k]) is float, k
    assert type(s.reward) is float and type(s.observation.CGM) is float
