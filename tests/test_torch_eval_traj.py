"""The port's trajectory scorer (`cli/eval_traj.py`) against the JAX
package's, on the fixture of tests/test_e2e.py::test_eval_traj_tool (a
known Sim3 of a helix with 1 mm noise and 4 ms of timestamp jitter), with
that test's own assertions. Both are the same numpy code: every metric
within 1e-9."""
import numpy as np
import pytest

from orbslam_birdview_tpu.cli import eval_traj as jeval
from orbslam_birdview_tpu_torch.cli import eval_traj

TOL = 1e-9


def write(path, ts, pos, quats=None):
    with open(path, "w") as f:
        f.write("# ts x y z qx qy qz qw\n")
        for k in range(len(ts)):
            q = "0 0 0 1" if quats is None else " ".join(
                f"{v:.9f}" for v in quats[k])
            f.write(f"{ts[k]:.6f} {pos[k, 0]:.6f} {pos[k, 1]:.6f} "
                    f"{pos[k, 2]:.6f} {q}\n")


@pytest.fixture
def helix(tmp_path):
    rng = np.random.default_rng(3)
    n = 120
    t = np.arange(n) / 30.0
    gt = np.stack([np.cos(t), np.sin(t), 0.1 * t], 1)
    th = np.radians(30)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    est = 2.5 * gt @ R.T + np.array([1.0, -2.0, 0.5])
    est = est + rng.normal(0, 0.001, est.shape)
    # rotations that drift, so the RPE's rotation term is not zero
    ang = 0.3 * t + rng.normal(0, 0.002, n)
    quats = np.stack([np.zeros(n), np.zeros(n), np.sin(ang / 2),
                      np.cos(ang / 2)], 1)
    write(tmp_path / "gt.txt", t, gt)
    write(tmp_path / "est.txt", t + 0.004, est)
    write(tmp_path / "est_rot.txt", t + 0.004, est, quats)
    return tmp_path, n


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("est", ["est.txt", "est_rot.txt"])
def test_evaluate_equals_jax(helix, with_scale, est):
    d, _ = helix
    args = (str(d / "gt.txt"), str(d / est), with_scale)
    got, want = eval_traj.evaluate(*args), jeval.evaluate(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


def test_associate_equals_jax(rng):
    a = np.sort(rng.uniform(0, 10, 300))
    b = np.concatenate([a[::2] + rng.normal(0, 0.01, 150),
                        rng.uniform(0, 10, 60)])
    rng.shuffle(b)
    for max_dt in (0.005, 0.02):
        for x, y in zip(eval_traj.associate(a, b, max_dt),
                        jeval.associate(a, b, max_dt)):
            np.testing.assert_array_equal(x, y)


def test_eval_traj_tool_assertions(helix):
    """tests/test_e2e.py::test_eval_traj_tool's bars on the port."""
    d, n = helix
    m = eval_traj.evaluate(str(d / "gt.txt"), str(d / "est.txt"),
                           with_scale=True)
    assert m["n_pairs"] == n
    assert abs(m["scale"] - 1 / 2.5) < 1e-3
    assert m["ate_rmse"] < 0.002
    m2 = eval_traj.evaluate(str(d / "gt.txt"), str(d / "est.txt"),
                            with_scale=False)
    assert m2["ate_rmse"] > 0.5
    printed = eval_traj.main([str(d / "gt.txt"), str(d / "est.txt"),
                              "--scale"])
    assert printed == m
