"""CLI surface tests (in-process main())."""
import numpy as np
import pytest

from qbot_tpu.cli import main


@pytest.fixture
def qb_file(tmp_path):
    def write(src):
        p = tmp_path / "prog.qb"
        p.write_text(src)
        return str(p)
    return write


class TestCli:
    def test_runs_program(self, qb_file, capsys):
        rc = main([qb_file('cout "hi"')])
        assert rc == 0
        assert capsys.readouterr().out == "hi\n"

    def test_missing_file(self, capsys):
        rc = main(["/nope/missing.qb"])
        assert rc == 1
        assert "File Not Found" in capsys.readouterr().out

    def test_script_error_exit_code(self, qb_file, capsys):
        rc = main([qb_file("bogus thing")])
        assert rc == 1
        assert "UnknownOperation" in capsys.readouterr().out

    def test_measurement_readout_format(self, qb_file, capsys):
        rc = main([qb_file("qset computation[0]\nmeas x ; computation\ncout x")])
        assert rc == 0
        out = capsys.readouterr().out
        assert out == "|0〉- 1.0 (100.0%)\n|1〉- 0.0 (0.0%)\n\n"

    def test_ensemble_flag(self, qb_file, capsys):
        rc = main([qb_file(
            "cdef x ; 1\n"
            "halt ProbVal([0.25, 0.75], [True, False])\n"
            "cdef x ; 2\n"
            "cout x"), "--ensemble"])
        assert rc == 0
        assert capsys.readouterr().out == "2\n"

    def test_compile_flag(self, qb_file, capsys):
        rc = main([qb_file(
            "qset tensorProd(comp[0], comp[0])\n"
            "gate hadamardGate ; 0\n"
            "gate pauliXGate ; 1 ; 0\n"
            "meas out ; comp"), "--compile"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "|0〉|0〉-" in out and "|1〉|1〉-" in out

    def test_backend_flag(self, qb_file):
        from qbot_tpu import backend
        rc = main([qb_file("qset comp[0]"), "--backend", "jax"])
        assert rc == 0
        assert backend.get_backend() == "jax"
        backend.set_backend("numpy")

    def test_profile_flag(self, qb_file, capsys):
        rc = main([qb_file("cdef x ; 1"), "--profile"])
        assert rc == 0
        assert "cdef" in capsys.readouterr().err

    def test_dtype_flag(self, qb_file, capsys):
        from qbot_tpu import backend
        try:
            rc = main([qb_file("qset comp[0]\ncout state.dtype"),
                       "--dtype", "c64"])
            assert rc == 0
            assert capsys.readouterr().out == "complex64\n"
        finally:
            backend.set_dtype(None)

    def test_dtype_default_is_c128(self, qb_file, capsys):
        rc = main([qb_file("qset comp[0]\ncout state.dtype")])
        assert rc == 0
        assert capsys.readouterr().out == "complex128\n"

    def test_smc_seed_flags(self, qb_file, capsys):
        # sampled SMC measurements: the post-measurement marginal of the
        # entangled partner is Monte Carlo, so it must be reproducible under
        # one seed and (with 2^-64 collision odds) differ across seeds
        src = ("qset tensorProd(comp[0], comp[0])\n"
               "gate hadamardGate ; 0\n"
               "gate pauliXGate ; 1 ; 0\n"
               "meas a ; comp ; [0]\n"
               "meas b ; comp ; [1]\n"
               "cout b")
        outs = []
        for seed in ("7", "7", "8"):
            rc = main([qb_file(src), "--compile", "--ensemble",
                       "--smc", "64", "--seed", seed])
            assert rc == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert outs[0] != outs[2]

    def test_mesh_flag_sharded_run(self, qb_file, capsys):
        # 2x4 mesh on the emulated 8-device CPU backend: the qubit axis is
        # 2^2 so --shard 2 runs under the user-chosen mesh shape
        rc = main([qb_file(
            "qset tensorExp(comp[0], 6)\n"
            "gate hadamardGate ; 0\n"
            "gate pauliXGate ; 5 ; 0\n"
            "meas out ; comp ; [0, 5]"),
            "--compile", "--shard", "2", "--mesh", "2x4"])
        assert rc == 0
        out = capsys.readouterr().out
        # planar executor is float32: 0.5 prints as 0.4999999…
        assert "|0〉|0〉- 0.49" in out and "|1〉|1〉- 0.49" in out
        assert "|0〉|1〉- 0.0" in out and "|1〉|0〉- 0.0" in out

    def test_mesh_flag_rejects_three_factors(self, qb_file, capsys):
        rc = main([qb_file("qset tensorExp(comp[0], 6)\nmeas out ; comp"),
                   "--compile", "--shard", "2", "--mesh", "2x2x2"])
        assert rc == 1
        assert "mesh error" in capsys.readouterr().err

    def test_mesh_flag_rejects_garbage(self, qb_file, capsys):
        rc = main([qb_file("qset tensorExp(comp[0], 6)\nmeas out ; comp"),
                   "--compile", "--shard", "2", "--mesh", "garbage"])
        assert rc == 1
        assert "mesh error" in capsys.readouterr().err

    def test_mesh_flag_rejects_non_pow2_qubit_axis(self, qb_file, capsys):
        rc = main([qb_file("qset tensorExp(comp[0], 6)\nmeas out ; comp"),
                   "--compile", "--shard", "2", "--mesh", "1x3"])
        assert rc == 1
        assert "power of two" in capsys.readouterr().err

    def test_mesh_flag_rejects_too_many_devices(self, qb_file, capsys):
        rc = main([qb_file("qset tensorExp(comp[0], 6)\nmeas out ; comp"),
                   "--compile", "--shard", "2", "--mesh", "64x64"])
        assert rc == 1
        assert "devices" in capsys.readouterr().err

    def test_engine_config_from_args(self):
        import argparse

        from qbot_tpu.utils.config import EngineConfig
        ns = argparse.Namespace(backend="jax", dtype="c64", seed=3,
                                mesh="2x4", profile=True, smc=16)
        cfg = EngineConfig.from_args(ns)
        assert cfg.mesh_shape == (2, 4)
        assert cfg.dtype == "c64" and cfg.seed == 3 and cfg.smc_particles == 16


def test_precision_flag_sets_dot_mode(tmp_path):
    from qbot_tpu.cli import main
    from qbot_tpu.tpu.dotplan import dot_mode

    f = tmp_path / "p.qb"
    f.write_text("qset tensorProd(comp[0], comp[0])\n"
                 "gate hadamardGate ; 0\n")
    try:
        assert main([str(f), "--precision", "bf16_3x"]) == 0
        assert dot_mode() == "bf16_3x"
    finally:
        from qbot_tpu.tpu.dotplan import set_dot_mode
        set_dot_mode("f32")


class _StubDevice:
    device_kind = "stub"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class TestAutoMesh:
    """--mesh auto: particles-only until the register needs qubit shards
    for device memory."""

    def test_policy_function(self):
        from qbot_tpu.utils.config import auto_mesh_shape

        # small registers: all devices on the particle axis (an unknown
        # width needs no budget; a known one takes the caller's)
        assert auto_mesh_shape(8, 10, hbm_budget_bytes=2**30 * 4.0) \
            == (8, 1)
        assert auto_mesh_shape(8, None) == (8, 1)
        # a register over the budget splits the qubit axis minimally
        assert auto_mesh_shape(8, 30, hbm_budget_bytes=2**30 * 4.0) \
            == (4, 2)
        assert auto_mesh_shape(8, 32, hbm_budget_bytes=2**30 * 4.0) \
            == (1, 8)
        with pytest.raises(ValueError):
            auto_mesh_shape(0)

    def test_memory_budget_from_device(self):
        from qbot_tpu.utils.config import device_memory_budget

        dev = _StubDevice({"bytes_limit": 8 * 2**30, "bytes_in_use": 0})
        assert device_memory_budget(dev) == 4 * 2**30

    @pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 0}])
    def test_memory_budget_refuses_unknown_device(self, stats):
        from qbot_tpu.utils.config import device_memory_budget

        with pytest.raises(ValueError, match="no memory limit"):
            device_memory_budget(_StubDevice(stats))

    def test_cli_auto_mesh_runs(self, tmp_path, capsys, monkeypatch):
        from qbot_tpu.cli import main
        from qbot_tpu.utils import config

        # the CPU backend reports no memory limit: give it a stub budget
        monkeypatch.setattr(config, "device_memory_budget",
                            lambda device=None: 4 * 2**30)

        prog = tmp_path / "p.qb"
        prog.write_text("qset tensorExp(comp[0], 4)\n"
                        "gate hadamardGate ; 0\n"
                        "meas m ; computation ; [0]\n")
        rc = main(["--compile", "--ensemble", "--mesh", "auto",
                   str(prog)])
        err = capsys.readouterr().err
        assert rc == 0
        assert "mesh auto:" in err
