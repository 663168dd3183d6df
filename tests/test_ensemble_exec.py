"""Device ensemble executor (mid-circuit measurement via exact particle
fan-out) vs the dense interpreter."""
import numpy as np
import pytest

from qbot_tpu import executeTxt
from qbot_tpu.frontend.lowering import (
    LoweringError,
    lower_program,
    run_lowered_ensemble,
)
from qbot_tpu.inference.ensemble_exec import ensemble_mixture


def _run_both(src, **kw):
    dense = executeTxt(src)
    lp = lower_program(src, mid_measure=True)
    results, ens = run_lowered_ensemble(lp, **kw)
    return dense, results, ens, lp


class TestMidMeasurement:
    def test_bell_then_more_gates(self):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 1 ; [0]\n"
               "meas a ; computation ; [0]\n"
               "gate hadamardGate ; 1\n"
               "meas b ; computation ; [1]")
        dense, results, ens, _ = _run_both(src)
        np.testing.assert_allclose(results["a"].probs, dense["a"].probs,
                                   atol=1e-6)
        np.testing.assert_allclose(results["b"].probs, dense["b"].probs,
                                   atol=1e-6)
        np.testing.assert_allclose(ensemble_mixture(ens), dense["state"],
                                   atol=1e-5)

    def test_fanout_particle_count(self):
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate hadamardGate ; 1\n"
               "meas a ; computation ; [0, 1]\n"
               "gate hadamardGate ; 2\n"
               "meas b ; computation ; [2]")
        _, results, ens, _ = _run_both(src)
        # reference-semantics collapse fans K^2 per meas: 16 then 16*4=64
        assert ens.num_particles == 64
        np.testing.assert_allclose(results["a"].probs, [0.25] * 4, atol=1e-6)

    def test_peek_does_not_collapse(self):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 1 ; [0]\n"
               "peek a ; computation ; [0]\n"
               "meas full ; computation")
        dense, results, ens, _ = _run_both(src)
        assert ens.num_particles <= 16   # only the final meas fans (K^2)
        np.testing.assert_allclose(results["a"].probs, [0.5, 0.5], atol=1e-6)
        # bell correlations survive the peek
        np.testing.assert_allclose(results["full"].probs,
                                   dense["full"].probs, atol=1e-6)

    def test_bell_basis_mid_measurement(self):
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 1 ; [0]\n"
               "meas a ; bell ; [0, 1]\n"
               "gate hadamardGate ; 2\n"
               "meas b ; computation ; [2]")
        dense, results, ens, _ = _run_both(src)
        np.testing.assert_allclose(results["a"].probs, dense["a"].probs,
                                   atol=1e-5)
        np.testing.assert_allclose(ensemble_mixture(ens), dense["state"],
                                   atol=1e-5)

    def test_hadamard_basis_collapse_state(self):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate xRotGate(0.7) ; 0\n"
               "meas a ; hadamard ; [0]\n"
               "gate hadamardGate ; 1")
        dense, results, ens, _ = _run_both(src)
        np.testing.assert_allclose(results["a"].probs, dense["a"].probs,
                                   atol=1e-5)
        np.testing.assert_allclose(ensemble_mixture(ens), dense["state"],
                                   atol=1e-5)

    def test_pruning_cap(self):
        # 3 two-qubit measurements in the hadamard frame: 4^3 = 64 branches,
        # capped at 16 heaviest; distribution error bounded by dropped mass
        lines = ["qset tensorExp(comp[0], 4)"]
        for q in range(4):
            lines.append(f"gate hadamardGate ; {q}")
        lines.append("meas a ; computation ; [0, 1]")
        lines.append("gate hadamardGate ; 0")
        lines.append("meas b ; computation ; [2, 3]")
        lines.append("gate hadamardGate ; 2")
        lines.append("meas c ; computation ; [0, 2]")
        src = "\n".join(lines)
        dense = executeTxt(src)
        lp = lower_program(src, mid_measure=True)
        results, ens = run_lowered_ensemble(lp, max_particles=16)
        assert ens.num_particles == 16
        np.testing.assert_allclose(results["a"].probs, dense["a"].probs,
                                   atol=1e-6)
        np.testing.assert_allclose(results["b"].probs, dense["b"].probs,
                                   atol=1e-6)


class TestEpilogueAndErrors:
    def test_epilogue_uses_outcomes(self, capsys):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "meas a ; computation ; [0]\n"
               "gate hadamardGate ; 1\n"
               "meas b ; computation ; [1]\n"
               "cout a\n"
               "pydo sink.append(b.probs[0])")
        lp = lower_program(src, mid_measure=True)
        lp.namespace["sink"] = []
        results, _ = run_lowered_ensemble(lp)
        assert "|0〉- 0.5" in capsys.readouterr().out
        assert abs(lp.namespace["sink"][0] - 0.5) < 1e-6

    def test_outcome_use_before_later_quantum_rejected(self):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "meas a ; computation ; [0]\n"
               "cout a\n"
               "gate hadamardGate ; 1")
        with pytest.raises(LoweringError):
            lower_program(src, mid_measure=True)

    def test_default_mode_unchanged(self):
        # without mid_measure, lowering still breaks at the first meas
        src = ("qset comp[0]\nmeas a ; computation\ncout a")
        lp = lower_program(src)
        assert lp.measure_name == "a"
        assert not lp.mid_measurements


class TestSamplingMode:
    def test_sampled_outcomes_distribution(self):
        """SMC-mode measurement: empirical outcome frequencies over many
        particles match the Born distribution."""
        import jax
        import jax.numpy as jnp

        from qbot_tpu.inference.ensemble_exec import (
            QuantumEnsemble,
            apply_plan_ensemble,
            measure_sample,
        )
        from qbot_tpu.tpu.circuit import Circuit
        from qbot_tpu.tpu.compiler import compile_circuit
        from qbot_tpu.tpu.planar import zero_state_planar

        n, B = 3, 512
        psi0 = zero_state_planar(n)
        ens = QuantumEnsemble(jnp.zeros(B),
                              jnp.broadcast_to(psi0, (B,) + psi0.shape))
        c = Circuit(n)
        c.ry(0, 1.0)        # P(1) = sin^2(0.5) ~ 0.2298
        ens = apply_plan_ensemble(ens, compile_circuit(c))
        ens, dist, outcomes = measure_sample(jax.random.PRNGKey(0), ens, n,
                                             [0])
        p1 = float(np.sin(0.5) ** 2)
        np.testing.assert_allclose(np.asarray(dist), [1 - p1, p1], atol=1e-5)
        freq = float(np.mean(np.asarray(outcomes)))
        assert abs(freq - p1) < 0.07
        # collapsed particles are exact basis states on the target qubit
        assert ens.num_particles == B

    def test_deep_measurement_sequence_fixed_memory(self):
        """20 sequential measurements at constant particle count (the exact
        fan-out would need 2^20 branches)."""
        import jax
        import jax.numpy as jnp

        from qbot_tpu.inference.ensemble_exec import (
            QuantumEnsemble,
            apply_plan_ensemble,
            measure_sample,
        )
        from qbot_tpu.tpu.circuit import Circuit
        from qbot_tpu.tpu.compiler import compile_circuit
        from qbot_tpu.tpu.planar import zero_state_planar

        n, B = 2, 64
        psi0 = zero_state_planar(n)
        ens = QuantumEnsemble(jnp.zeros(B),
                              jnp.broadcast_to(psi0, (B,) + psi0.shape))
        h = Circuit(n).h(0)
        plan = compile_circuit(h)
        key = jax.random.PRNGKey(1)
        for i in range(20):
            key, k = jax.random.split(key)
            ens = apply_plan_ensemble(ens, plan)
            ens, dist, _ = measure_sample(k, ens, n, [0])
            assert ens.num_particles == B
            np.testing.assert_allclose(np.asarray(dist), [0.5, 0.5],
                                       atol=1e-4)
        assert np.all(np.isfinite(np.asarray(ens.psi)))


class TestCollapseModes:
    def test_projective_mode_keeps_correlations(self):
        """Textbook collapse preserves outcome-rest classical correlation;
        reference mode decoheres it into a product state."""
        import jax.numpy as jnp

        from qbot_tpu.inference.ensemble_exec import (
            ensemble_mixture,
            init_ensemble,
            measure_fanout,
        )
        from qbot_tpu.tpu.planar import to_planar

        bell = np.zeros(4, complex)
        bell[0] = bell[3] = 2**-0.5
        ens0 = init_ensemble(jnp.asarray(to_planar(bell)))

        proj, _ = measure_fanout(ens0, 2, [0], mode="projective")
        rho_p = ensemble_mixture(proj)
        want_p = np.diag([0.5, 0, 0, 0.5])          # correlated mixture
        np.testing.assert_allclose(rho_p, want_p, atol=1e-6)

        ref, _ = measure_fanout(ens0, 2, [0], mode="reference")
        rho_r = ensemble_mixture(ref)
        want_r = np.eye(4) / 4                      # decohered product
        np.testing.assert_allclose(rho_r, want_r, atol=1e-6)
        # and the reference-mode result matches the dense interpreter
        dense = executeTxt("qset bell[0]\nmeas x ; comp ; 0")
        np.testing.assert_allclose(rho_r, dense["state"], atol=1e-6)


class TestDiscAndMixedPrep:
    def test_disc_matches_dense_interpreter(self):
        # trace-out on the device ensemble path: Σ w|ψ⟩⟨ψ| must equal the
        # dense interpreter's partial trace (reference operators.py:169-188)
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 1 ; [0]\n"
               "gate hadamardGate ; 2\n"
               "disc 1")
        dense, _, ens, lp = _run_both(src)
        np.testing.assert_allclose(ensemble_mixture(ens), dense["state"],
                                   atol=1e-5)
        assert ens.psi.shape[-1] == 4          # register shrank 3 → 2 qubits

    def test_disc_then_more_gates_and_meas(self):
        # post-discard ops use the SHRUNK register numbering, like the dense
        # interpreter
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 2 ; [0]\n"
               "disc [1]\n"
               "gate hadamardGate ; 1\n"
               "meas a ; computation ; [1]")
        dense, results, ens, _ = _run_both(src)
        np.testing.assert_allclose(results["a"].probs, dense["a"].probs,
                                   atol=1e-6)
        np.testing.assert_allclose(ensemble_mixture(ens), dense["state"],
                                   atol=1e-5)

    def test_mixed_state_prep(self):
        # a ProbVal over product states folds to a mixed ρ; the ensemble
        # preps it as its eigendecomposition (SURVEY.md §7 decision 2)
        src = ("qset ProbVal([0.25, 0.75], "
               "[tensorProd(comp[0], comp[0]), tensorProd(comp[1], comp[1])])\n"
               "gate hadamardGate ; 0\n"
               "meas a ; computation ; [0]")
        dense, results, ens, lp = _run_both(src)
        assert lp.initial_density is not None
        np.testing.assert_allclose(results["a"].probs, dense["a"].probs,
                                   atol=1e-6)
        np.testing.assert_allclose(ensemble_mixture(ens), dense["state"],
                                   atol=1e-5)

    def test_mixed_prep_disc_and_midmeas_12q(self):
        # the VERDICT done-criterion: a 12-qubit program mixing mixed-state
        # prep, disc and mid-circuit meas matches executeTxt exactly
        src = ("qset tensorProd("
               "ProbVal([0.5, 0.5], [comp[0], comp[1]]), "
               "tensorExp(comp[0], 11))\n"
               "gate hadamardGate ; 1\n"
               "gate pauliXGate ; 6 ; [1]\n"
               "gate hadamardGate ; 11\n"
               "meas a ; computation ; [6]\n"
               "disc [1, 11]\n"
               "gate hadamardGate ; 0\n"
               "meas b ; computation ; [0, 5]")
        dense, results, ens, lp = _run_both(src)
        assert any(type(s).__name__ == "DiscSpec"
                   for s in lp.mid_measurements)
        np.testing.assert_allclose(results["a"].probs, dense["a"].probs,
                                   atol=1e-6)
        np.testing.assert_allclose(results["b"].probs, dense["b"].probs,
                                   atol=1e-6)
        np.testing.assert_allclose(ensemble_mixture(ens), dense["state"],
                                   atol=2e-5)

    def test_disc_sampled_mode_register_shrinks(self):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 1 ; [0]\n"
               "disc 0")
        from qbot_tpu.frontend.lowering import lower_program
        lp = lower_program(src, mid_measure=True)
        _, ens = run_lowered_ensemble(lp, sample=32, seed=1)
        assert ens.num_particles == 32
        assert ens.psi.shape[-1] == 2
        # bell-pair partner: Tr_0 ρ = I/2
        mix = ensemble_mixture(ens)
        assert abs(mix[0, 0] + mix[1, 1] - 1.0) < 1e-5

    def test_disc_rejected_in_default_mode(self):
        import pytest as _pytest
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "disc 0\n"
               "meas a ; computation")
        with _pytest.raises(LoweringError):
            lower_program(src)


class TestElasticRecovery:
    SRC = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
           "gate hadamardGate ; 0\n"
           "gate pauliXGate ; 1 ; [0]\n"
           "meas a ; computation ; [0]\n"
           "gate hadamardGate ; 2\n"
           "meas b ; computation ; [2]\n"
           "disc [2]\n"
           "meas c ; computation")

    def test_restart_from_snapshot_matches_uninterrupted(self, tmp_path,
                                                         monkeypatch):
        from qbot_tpu.frontend.lowering import lower_program
        from qbot_tpu.inference import ensemble_exec as ee

        lp = lower_program(self.SRC, mid_measure=True)
        want, want_ens = run_lowered_ensemble(lp)

        # crash the run after the second measurement event ("lost host")
        ckpt = str(tmp_path / "snap")
        real_fanout = ee.measure_fanout
        calls = {"n": 0}

        def dying_fanout(*a, **kw):
            calls["n"] += 1
            if calls["n"] > 2:
                raise RuntimeError("injected host loss")
            return real_fanout(*a, **kw)

        import qbot_tpu.inference.ensemble_exec as ee_mod
        monkeypatch.setattr(ee_mod, "measure_fanout", dying_fanout)
        lp2 = lower_program(self.SRC, mid_measure=True)
        with pytest.raises(RuntimeError, match="injected host loss"):
            run_lowered_ensemble(lp2, checkpoint_dir=ckpt)
        monkeypatch.setattr(ee_mod, "measure_fanout", real_fanout)

        # a fresh invocation resumes from the latest snapshot (event 2):
        # only the remaining events execute, results match exactly
        lp3 = lower_program(self.SRC, mid_measure=True)
        got, got_ens = run_lowered_ensemble(lp3, checkpoint_dir=ckpt)
        for name in ("a", "b", "c"):
            np.testing.assert_allclose(got[name].probs, want[name].probs,
                                       atol=1e-6)
        np.testing.assert_allclose(ensemble_mixture(got_ens),
                                   ensemble_mixture(want_ens), atol=1e-5)

    def test_snapshot_files_roll(self, tmp_path):
        from qbot_tpu.frontend.lowering import lower_program
        from qbot_tpu.utils.checkpoint import CheckpointManager

        ckpt = str(tmp_path / "snap2")
        lp = lower_program(self.SRC, mid_measure=True)
        run_lowered_ensemble(lp, checkpoint_dir=ckpt)
        steps = CheckpointManager(ckpt).all_steps()
        # one snapshot per event (2 meas + disc + meas), retention keeps 3
        assert steps == [2, 3, 4]


class TestPrunedMassTracking:
    """VERDICT weak #7: the top-k prune must not lose mass silently."""

    def test_no_prune_no_loss(self):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "meas a ; computation ; [0]")
        _, _, ens, _ = _run_both(src)
        assert float(ens.lost_mass) == 0.0

    def test_deep_measurements_report_lost_mass(self):
        # 4 qubits, all superposed, three 2-qubit measurements: the K^2
        # reference fan-out wants 16 -> 256 -> 4096 particles; capping at 32
        #necessarily drops real mass, which must surface as lost_mass + a warning
        src = ("qset tensorProd(comp[0], comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate hadamardGate ; 1\n"
               "gate hadamardGate ; 2\n"
               "gate hadamardGate ; 3\n"
               "meas a ; computation ; [0, 1]\n"
               "meas b ; computation ; [1, 2]\n"
               "meas c ; computation ; [2, 3]")
        from qbot_tpu.frontend.lowering import lower_program

        lp = lower_program(src, mid_measure=True)
        with pytest.warns(RuntimeWarning, match="probability mass"):
            results, ens = run_lowered_ensemble(lp, max_particles=32)
        lost = float(ens.lost_mass)
        assert 0.0 < lost < 1.0

        # lost_mass is an honest total-variation bound on the final readout
        dense = executeTxt(src)
        for name in ("a", "b", "c"):
            tv = 0.5 * np.abs(np.asarray(results[name].probs)
                              - np.asarray(dense[name].probs)).sum()
            assert tv <= lost + 1e-6

    def test_lost_mass_survives_checkpoint_resume(self, tmp_path):
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate hadamardGate ; 1\n"
               "gate hadamardGate ; 2\n"
               "meas a ; computation ; [0, 1]\n"
               "meas b ; computation ; [1, 2]")
        from qbot_tpu.frontend.lowering import lower_program

        lp = lower_program(src, mid_measure=True)
        with pytest.warns(RuntimeWarning):
            _, want_ens = run_lowered_ensemble(lp, max_particles=8)

        ckpt = str(tmp_path / "snap")
        lp2 = lower_program(src, mid_measure=True)
        with pytest.warns(RuntimeWarning):
            run_lowered_ensemble(lp2, max_particles=8, checkpoint_dir=ckpt)
        # resume from the final snapshot: accumulated loss is restored
        lp3 = lower_program(src, mid_measure=True)
        with pytest.warns(RuntimeWarning):
            _, got_ens = run_lowered_ensemble(lp3, max_particles=8,
                                              checkpoint_dir=ckpt)
        assert float(got_ens.lost_mass) == pytest.approx(
            float(want_ens.lost_mass), abs=1e-9)

    def test_sampling_mode_does_not_accumulate(self):
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate hadamardGate ; 1\n"
               "meas a ; computation ; [0, 1]\n"
               "meas b ; computation ; [1, 2]")
        from qbot_tpu.frontend.lowering import lower_program

        lp = lower_program(src, mid_measure=True)
        _, ens = run_lowered_ensemble(lp, sample=64, seed=1)
        assert float(ens.lost_mass) == 0.0


class TestTargetedQset:
    """VERDICT r3 missing #3: targeted qset on the device paths —
    differential vs the dense interpreter (reference replaceArbitrary,
    /root/reference/qbot/operators.py:133-166)."""

    def _both(self, src, **kw):
        from qbot_tpu.frontend.interpreter import executeTxt
        from qbot_tpu.frontend.lowering import lower_program

        ns = executeTxt(src)
        lp = lower_program(src, mid_measure=True)
        res, ens = run_lowered_ensemble(lp, **kw)
        return ns, res, ens

    def test_pure_ket_insert_on_entangled_register(self):
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 2 ; [0]\n"          # entangle 0 and 2
               "qset hadamard.kets[0] ; [0]\n"        # replace qubit 0
               "meas m ; computation")
        ns, res, ens = self._both(src)
        np.testing.assert_allclose(res["m"].probs, ns["m"].probs,
                                   atol=1e-7)
        np.testing.assert_allclose(ensemble_mixture(ens),
                                   np.asarray(ns["state"], complex),
                                   atol=1e-7)

    def test_density_insert_unsorted_targets(self):
        # new state's qubit j lands on targets[j] — order preserved
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 1\n"
               "qset tensorProd(hadamard[0], comp[1]) ; [2, 0]\n"
               "meas m ; computation")
        ns, res, ens = self._both(src)
        np.testing.assert_allclose(res["m"].probs, ns["m"].probs,
                                   atol=1e-7)
        np.testing.assert_allclose(ensemble_mixture(ens),
                                   np.asarray(ns["state"], complex),
                                   atol=1e-7)

    def test_mixed_new_state_fans_particles(self):
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "qset ProbVal([0.3, 0.7], [comp[0], comp[1]]) ; [1]\n"
               "meas m ; computation")
        ns, res, ens = self._both(src)
        np.testing.assert_allclose(res["m"].probs, ns["m"].probs,
                                   atol=1e-7)
        np.testing.assert_allclose(ensemble_mixture(ens),
                                   np.asarray(ns["state"], complex),
                                   atol=1e-7)

    def test_probval_targets_fan_out(self):
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "qset comp[1] ; ProbVal([0.25, 0.75], [[0], [2]])\n"
               "meas m ; computation")
        ns, res, ens = self._both(src)
        np.testing.assert_allclose(res["m"].probs, ns["m"].probs,
                                   atol=1e-7)
        np.testing.assert_allclose(ensemble_mixture(ens),
                                   np.asarray(ns["state"], complex),
                                   atol=1e-7)

    def test_entangled_two_qubit_new_state(self):
        src = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate hadamardGate ; 2\n"
               "qset bell.kets[0] ; [0, 1]\n"
               "meas m ; computation ; [0, 1]")
        ns, res, ens = self._both(src)
        np.testing.assert_allclose(res["m"].probs, ns["m"].probs,
                                   atol=1e-7)
        np.testing.assert_allclose(ensemble_mixture(ens),
                                   np.asarray(ns["state"], complex),
                                   atol=1e-7)

    def test_sampling_mode_matches_exact(self):
        # round 5 (VERDICT r4 #5): targeted qset WORKS under sample > 0
        # — per-particle traced-outcome + new-state-branch draws
        from qbot_tpu.frontend.lowering import lower_program

        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "qset comp[0] ; [1]\n"
               "meas m ; computation")
        lp = lower_program(src, mid_measure=True)
        exact, _ = run_lowered_ensemble(lp)
        lp2 = lower_program(src, mid_measure=True)
        sampled, _ = run_lowered_ensemble(lp2, sample=1024, seed=2)
        np.testing.assert_allclose(sampled["m"].probs, exact["m"].probs,
                                   atol=0.06)


class TestTilingSafeCollapse:
    """The large-register collapse formulations (bit masks, staged
    reductions, outcome-selected sample collapse) must agree EXACTLY
    with the direct (2,)^n formulations — same keys, same outcomes,
    same states."""

    def _rand_ens(self, n, B=3, seed=0):
        import jax.numpy as jnp

        from qbot_tpu.inference.ensemble_exec import QuantumEnsemble

        rng = np.random.default_rng(seed)
        psi = rng.normal(size=(B, 2, 2**n)).astype(np.float32)
        psi /= np.sqrt((psi**2).sum(axis=(1, 2), keepdims=True))
        lw = np.log(rng.dirichlet(np.ones(B)))
        return QuantumEnsemble(jnp.asarray(lw), jnp.asarray(psi))

    @pytest.mark.parametrize("targets", [[0], [16], [0, 16], [3, 9],
                                         [15, 16], [0, 1, 2]])
    def test_fanout_and_sample_match_direct(self, targets, monkeypatch):
        import jax

        import qbot_tpu.inference.ensemble_exec as ee

        n = 17
        ens = self._rand_ens(n)
        key = jax.random.PRNGKey(7)

        def run_all():
            m_ens, m_dist = ee.measure_fanout(ens, n, targets, 64,
                                              mode="projective")
            d_ens = ee.discard_fanout(ens, n, targets, 64)
            s_ens, s_dist, s_out = ee.measure_sample(key, ens, n, targets)
            ds_ens = ee.discard_sample(key, ens, n, targets)
            return (np.asarray(m_dist), np.asarray(m_ens.psi),
                    np.asarray(d_ens.psi), np.asarray(s_dist),
                    np.asarray(s_out), np.asarray(s_ens.psi),
                    np.asarray(ds_ens.psi))

        monkeypatch.setattr(ee, "_FORCE_SAFE", True)
        new = run_all()
        monkeypatch.setattr(ee, "_FORCE_SAFE", False)
        old = run_all()
        # the two formulations reduce 2^17 float32 amplitudes in different
        # orders (jitted XLA picks per-formulation reduction trees), so
        # agreement is bounded by f32 summation noise ~1e-5, not exactness
        for a, b in zip(new, old):
            np.testing.assert_allclose(a, b, atol=5e-5)

    def test_reference_mode_relocation_matches_direct(self, monkeypatch):
        import qbot_tpu.inference.ensemble_exec as ee

        n = 17
        ens = self._rand_ens(n, B=2)
        monkeypatch.setattr(ee, "_FORCE_SAFE", True)
        new_e, new_d = ee.measure_fanout(ens, n, [2, 16], 64,
                                         mode="reference")
        monkeypatch.setattr(ee, "_FORCE_SAFE", False)
        old_e, old_d = ee.measure_fanout(ens, n, [2, 16], 64,
                                         mode="reference")
        # f32 reduction-order noise between the jitted formulations (see
        # test_fanout_and_sample_match_direct)
        np.testing.assert_allclose(np.asarray(new_d), np.asarray(old_d),
                                   atol=5e-5)
        np.testing.assert_allclose(np.asarray(new_e.psi),
                                   np.asarray(old_e.psi), atol=5e-5)


class TestSafeLayoutSelection:
    """The formulation follows the register width on every backend:
    direct (2,)*n views below _MASK_N_MIN qubits (or past 12 targets),
    mask/carrier forms from there up.  ``_FORCE_SAFE`` True / False pins
    one form where the mask/carrier forms apply."""

    @pytest.mark.parametrize("n,t,safe", [(8, 1, False), (13, 2, False),
                                          (14, 1, True), (24, 3, True),
                                          (30, 13, False)])
    def test_default_selects_by_width(self, n, t, safe):
        import qbot_tpu.inference.ensemble_exec as ee

        assert ee._FORCE_SAFE is None
        assert ee._safe_layouts(n, t) is safe

    def test_force_selects_safe_where_it_applies(self, monkeypatch):
        import qbot_tpu.inference.ensemble_exec as ee

        monkeypatch.setattr(ee, "_FORCE_SAFE", True)
        assert ee._safe_layouts(ee._MASK_N_MIN, 1) is True
        assert ee._safe_layouts(ee._MASK_N_MIN - 1, 1) is False
        assert ee._safe_layouts(24, 13) is False
        monkeypatch.setattr(ee, "_FORCE_SAFE", False)
        assert ee._safe_layouts(24, 3) is False
