"""Aux subsystem tests: checkpointing, numeric guards, config, helpers."""
import numpy as np
import pytest

from qbot_tpu.helpers import (
    best_rational,
    complex_to_algebra,
    float_to_algebra,
    int_log2,
    nth_roots_of_unity,
    state_vec_str,
)
from qbot_tpu.utils.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from qbot_tpu.utils.config import EngineConfig
from qbot_tpu.utils.guards import NumericError, assert_finite, check_norm


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        arrays = {"psi": np.arange(8.0), "weights": np.ones(4)}
        save_checkpoint(str(tmp_path / "ck"), arrays, {"pc": 17}, step=3)
        got, meta = load_checkpoint(str(tmp_path / "ck"))
        np.testing.assert_allclose(got["psi"], arrays["psi"])
        assert meta == {"pc": 17, "step": 3}

    def test_manager_retention_and_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        for step in (1, 2, 3):
            mgr.save(step, {"x": np.array([float(step)])})
        assert mgr.all_steps() == [2, 3]
        arrays, meta = mgr.restore()
        assert float(arrays["x"][0]) == 3.0
        arrays, _ = mgr.restore(step=2)
        assert float(arrays["x"][0]) == 2.0

    def test_restore_empty_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "none"))
        with pytest.raises(FileNotFoundError):
            mgr.restore()


class TestGuards:
    def test_assert_finite(self):
        assert_finite(np.ones(3))
        with pytest.raises(NumericError):
            assert_finite(np.array([1.0, np.nan]))

    def test_check_norm_planar_and_complex(self):
        psi = np.zeros(4, dtype=complex)
        psi[0] = 1
        check_norm(psi)
        planar = np.stack([psi.real, psi.imag])
        check_norm(planar)
        with pytest.raises(NumericError):
            check_norm(2 * psi)

    def test_checked_jit_wrapper(self):
        import jax.numpy as jnp

        from qbot_tpu.utils.guards import checked
        err, out = checked(lambda x: x * 2)(jnp.ones(3))
        err.throw()  # no error
        err, out = checked(lambda x: x / 0.0)(jnp.ones(3))
        with pytest.raises(Exception):
            err.throw()


class TestConfig:
    def test_from_args(self):
        class A:
            backend = "jax"
            dtype = "c64"
            seed = 7
            mesh = "2x4"
            profile = True
        cfg = EngineConfig.from_args(A())
        assert cfg.backend == "jax" and cfg.mesh_shape == (2, 4)

    def test_bad_mesh(self):
        class A:
            backend = "numpy"
            mesh = "8"
        with pytest.raises(ValueError):
            EngineConfig.from_args(A())


class TestHelpers:
    def test_int_log2(self):
        assert int_log2(0) == 0
        assert int_log2(1) == 0
        assert int_log2(1024) == 10

    def test_roots_of_unity(self):
        r = nth_roots_of_unity(4)
        np.testing.assert_allclose(r, [1, 1j, -1, -1j], atol=1e-12)

    def test_best_rational(self):
        assert best_rational(0.5, 50) == (1, 2)
        assert best_rational(1.25, 50) == (5, 4)
        n, d = best_rational(np.pi, 50)
        assert abs(n / d - np.pi) < 1e-2

    def test_float_to_algebra(self):
        assert float_to_algebra(0.5) == "1/2"
        assert float_to_algebra(2**-0.5) == "√2/2"
        assert float_to_algebra(np.pi / 4) == "π/4"

    def test_complex_to_algebra(self):
        assert complex_to_algebra(complex(0.5, 0)) == "1/2"
        assert complex_to_algebra(complex(0, 1)) == "1j"

    def test_state_vec_str_bit_width(self):
        # fixed vs reference: ket labels use log2(size) bits
        s = state_vec_str(np.array([1, 0, 0, 0], dtype=complex))
        assert "|00〉" in s


class TestOrbaxCheckpoint:
    def test_orbax_roundtrip(self, tmp_path):
        ocp = pytest.importorskip("orbax.checkpoint")
        from qbot_tpu.utils.checkpoint import OrbaxCheckpointManager

        mgr = OrbaxCheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
        arrays = {"psi": np.arange(8.0), "w": np.ones(3)}
        mgr.save(0, arrays, {"pc": 7})
        mgr.save(1, {"psi": np.arange(8.0) * 2, "w": np.zeros(3)}, {"pc": 9})
        mgr.wait()
        assert mgr.latest_step() == 1
        got, meta = mgr.restore()
        np.testing.assert_allclose(np.asarray(got["psi"]), np.arange(8.0) * 2)
        assert meta["pc"] == 9
        got0, meta0 = mgr.restore(0)
        assert meta0["pc"] == 7
        mgr.close()

    def test_orbax_retention(self, tmp_path):
        pytest.importorskip("orbax.checkpoint")
        from qbot_tpu.utils.checkpoint import OrbaxCheckpointManager

        mgr = OrbaxCheckpointManager(str(tmp_path / "ck2"), max_to_keep=2)
        for s in range(4):
            mgr.save(s, {"x": np.full(2, float(s))})
        mgr.wait()
        assert mgr.all_steps() == [2, 3]
        mgr.close()

    def test_factory_prefers_orbax(self, tmp_path):
        from qbot_tpu.utils.checkpoint import make_checkpoint_manager

        mgr = make_checkpoint_manager(str(tmp_path / "ck3"))
        mgr.save(0, {"x": np.ones(2)})
        if hasattr(mgr, "wait"):
            mgr.wait()
        arrays, _ = mgr.restore()
        np.testing.assert_allclose(np.asarray(arrays["x"]), np.ones(2))
        if hasattr(mgr, "close"):
            mgr.close()


class TestCompileCache:
    def test_enable_and_warm_detection(self, tmp_path, monkeypatch):
        import jax

        from qbot_tpu.utils import compile_cache as cc

        target = str(tmp_path / "cache")
        monkeypatch.setattr(cc, "_enabled", False)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setenv("QBOT_TPU_COMPILE_CACHE", target)
        assert cc.cache_is_warm() is False
        prev = jax.config.jax_compilation_cache_dir
        try:
            got = cc.enable_compile_cache()
            assert got == target
            assert jax.config.jax_compilation_cache_dir == target
            # idempotent re-enable keeps the configured dir
            assert cc.enable_compile_cache() == target
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)

    @pytest.mark.parametrize("override", [None, "repo-dir"])
    def test_jax_env_dir_wins_and_is_not_set_in_code(self, tmp_path,
                                                      monkeypatch, override):
        import jax

        from qbot_tpu.utils import compile_cache as cc

        env_dir = str(tmp_path / "jax-env-cache")
        monkeypatch.setattr(cc, "_enabled", False)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        if override:
            monkeypatch.setenv("QBOT_TPU_COMPILE_CACHE",
                               str(tmp_path / override))
        else:
            monkeypatch.delenv("QBOT_TPU_COMPILE_CACHE", raising=False)
        prev = jax.config.jax_compilation_cache_dir
        try:
            assert cc.cache_dir() == env_dir
            assert cc.cache_is_warm() is False
            assert cc.enable_compile_cache() == env_dir
            # JAX reads the variable itself; the code sets no directory
            assert jax.config.jax_compilation_cache_dir == prev
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)

    def test_default_dir_without_env(self, monkeypatch):
        from pathlib import Path

        from qbot_tpu.utils import compile_cache as cc

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.delenv("QBOT_TPU_COMPILE_CACHE", raising=False)
        got = Path(cc.cache_dir())
        assert got.name == ".jax_cache"
        assert (got.parent / "qbot_tpu" / "utils" / "compile_cache.py"
                ).is_file()

    def test_off_switch(self, monkeypatch):
        from qbot_tpu.utils import compile_cache as cc

        monkeypatch.setattr(cc, "_enabled", False)
        monkeypatch.setenv("QBOT_TPU_COMPILE_CACHE", "off")
        assert cc.enable_compile_cache() is None
        assert cc.cache_is_warm() is False
