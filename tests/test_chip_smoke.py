"""chip_smoke.py's phases at tiny sizes on the CPU (the device check is
the only part that needs a GPU; it is tested to refuse the CPU)."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_device()


def test_main_refuses_cpu_before_any_phase(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_outcome_table_parses_cli_lines():
    text = ("lowered: 3 qubits\n"
            "|0〉|0〉- 0.25 (25.0%)\n"
            "|0〉|1〉- 0.75 (75.0%)\n")
    assert chip_smoke._outcome_table(text) == [0.25, 0.75]


@pytest.mark.parametrize("n,marked,iters,k", [(6, 37, 2, 2), (8, 5, 3, 3)])
def test_grover_marginal_matches_dense_simulation(n, marked, iters, k):
    import bench
    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.planar import (
        apply_plan_planar,
        planar_probs,
        zero_state_planar,
    )

    init, body = bench.grover_circuits(n, marked)
    psi = apply_plan_planar(zero_state_planar(n), compile_circuit(init))
    for _ in range(iters):
        psi = apply_plan_planar(psi, compile_circuit(body))
    want = np.asarray(planar_probs(psi, list(range(k)), n))
    got = chip_smoke._grover_marginal(n, marked, iters, k)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert abs(got.sum() - 1.0) < 1e-12


def test_phase_grover(tmp_path):
    res = chip_smoke.phase_grover(str(tmp_path), n=8, repeats=3,
                                  cli_iters=1, cli_k=2)
    assert res["rel_err"] <= chip_smoke.GROVER_RTOL
    assert res["cli_rel_err"] <= chip_smoke.GROVER_RTOL


def test_phase_general():
    res = chip_smoke.phase_general(n=14, layers=2)
    for name in ("dot", "step"):
        assert res[name]["rel_l2"] <= chip_smoke.STATE_RTOL


def test_phase_density():
    res = chip_smoke.phase_density(nd=7, layers=2)
    assert abs(res["trace"] - 1.0) <= chip_smoke.TRACE_TOL


def test_phase_smc(tmp_path):
    res = chip_smoke.phase_smc(str(tmp_path), n=18, particles=32,
                               n_dense=6)
    assert res["bench"]["sample_sigma"] <= chip_smoke.SIGMAS
    assert max(res["dependent"]["sample_sigma"].values()) <= chip_smoke.SIGMAS
    assert res["dependent"]["exact_vs_closed_form"] <= chip_smoke.DIST_ATOL


def test_check_freqs_rejects_a_sampler_stuck_at_zero():
    assert chip_smoke._check_freqs("x", [0.5, 0.5], [0.5, 0.5], 32) == 0.0
    with pytest.raises(AssertionError, match="sampled frequencies"):
        chip_smoke._check_freqs("x", [1.0, 0.0], [0.2, 0.8], 32)


def test_dependent_program_matches_dense_interpreter():
    from qbot_tpu.frontend.interpreter import executeTxt

    got = executeTxt(chip_smoke.dependent_program(6))
    for name, want in chip_smoke.dependent_exact().items():
        np.testing.assert_allclose(got[name].probs, want, atol=1e-9)


def test_dependent_sample_check_rejects_unsampled_marginals():
    """Marginals that no set of 32 sampled particles can produce (the
    exact mixture, e.g. from a collapse that kept every branch) fail."""
    from types import SimpleNamespace

    exact = chip_smoke.dependent_exact()
    sampled = {k: SimpleNamespace(probs=np.asarray(v))
               for k, v in exact.items()}
    with pytest.raises(AssertionError, match="not k/32"):
        chip_smoke._check_dependent_sample(sampled, None, None, 32)


def test_phase_grad():
    res = chip_smoke.phase_grad(n=6, depth=2)
    for name in ("step", "dot"):
        assert res[name]["rel_l2"] <= chip_smoke.GRAD_RTOL


def test_phase_multi_planar():
    res = chip_smoke.phase_multi_planar(n=10, layers=2, k=2)
    assert res["devices"] == 4


def test_phase_multi_ensemble(tmp_path):
    """n_local = 14 on the (1, 4) mesh, so the mask/carrier formulations
    engage in q-sharded sample mode."""
    res = chip_smoke.phase_multi_ensemble(str(tmp_path), n=16,
                                          particles=32)
    assert set(res) >= {"4x1", "2x2", "1x4"}
    assert max(res["1x4"]["sample_sigma"].values()) <= chip_smoke.SIGMAS


def test_state_errors_and_gate_of():
    from qbot_tpu.tpu.circuit import Circuit

    err = chip_smoke._state_errors(np.array([1.0, 0.0]),
                                   np.array([1.0, 1e-6]))
    assert err["max_abs"] == pytest.approx(1e-6)
    c = Circuit(2).cx(0, 1)
    gate, qubits = chip_smoke._gate_of(c.ops[0])
    assert qubits == (0, 1)
    np.testing.assert_allclose(gate[2:, 2:], [[0, 1], [1, 0]])
