"""The example scripts are the reference's smoke-test layer (SURVEY.md §4);
run them end to end."""

import pathlib
import runpy
import subprocess
import sys

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def run_example(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")


def test_batched_stateless(tmp_path, monkeypatch, capsys):
    run_example("batched_stateless.py", tmp_path, monkeypatch)
    assert (tmp_path / "test.cpp").exists()
    assert (tmp_path / "test.lir").exists()
    code = (tmp_path / "test.cpp").read_text()
    assert 'extern "C" void time_step(double* Q, double dt)' in code
    # The emitted C++ must actually compile against the bundled physics.
    from exahype_jax.backends.cpp_runtime import NATIVE_DIR

    proc = subprocess.run(
        [
            "g++", "-O2", "-fsyntax-only", f"-I{NATIVE_DIR}",
            str(tmp_path / "test.cpp"),
        ],
        capture_output=True,
        text=True,
    )
    assert proc.returncode == 0, proc.stderr


def test_exahype_ir_demo(tmp_path, monkeypatch):
    run_example("exahype_ir_demo.py", tmp_path, monkeypatch)
    text = (tmp_path / "demo.eir").read_text()
    from exahype_jax.ir import parse_kernel

    kernel = parse_kernel(text)
    assert len(kernel.stencils) == 2
    assert kernel.stencils[0].fluxes[0].call.func == "Flux_x"


def test_kernel_generator(tmp_path, monkeypatch):
    run_example("kernel_generator.py", tmp_path, monkeypatch)
    code = (tmp_path / "generated_kernel.cpp").read_text()
    assert "void time_step(::exahype2::CellData& patchData, ::tarch::timing::Measurement& timingComputeKernel)" in code
    assert '#include "peano4/peano.h"' in code
    # CellData member convention: member[patch][per-patch linear index].
    assert "QIn[patch][" in code
    assert "patchData.dt" in code
    # Solver-instance-qualified physics call.
    assert "instanceOfFVRusanovSolver.flux(" in code
    # Namespace-qualified helper.
    assert "exahype2::fv::getVolumeCentre(" in code


def test_dynamic_refinement(tmp_path, monkeypatch):
    import sys

    monkeypatch.setattr(sys, "argv", ["dynamic_refinement.py"])
    run_example("dynamic_refinement.py", tmp_path, monkeypatch)


def test_aderdg_euler3d_example(tmp_path, monkeypatch):
    import sys

    monkeypatch.setattr(sys, "argv", ["aderdg_euler3d.py", "--cpu"])
    run_example("aderdg_euler3d.py", tmp_path, monkeypatch)


def test_swe_bathymetry_example(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["swe_bathymetry.py", "--cpu"])
    run_example("swe_bathymetry.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "bathymetry frozen: True" in out


def test_limited_amr_blast(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["limited_amr_blast.py"])
    run_example("limited_amr_blast.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "limited AMR blast: conservative + admissible" in out


def test_flrw_cosmology(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["flrw_cosmology.py", "--cpu"])
    run_example("flrw_cosmology.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "matches the Friedmann reference" in out


@pytest.mark.slow
def test_limited_amr_blast3d(tmp_path, monkeypatch, capsys):
    """The round-4 3-D capstone: limited AMR blast with overlapped
    re-gridding, conservative to rounding with adequate coarse capacity."""
    import sys

    monkeypatch.setattr(
        sys, "argv", ["limited_amr_blast3d.py", "--cpu", "--chunks", "2"]
    )
    run_example("limited_amr_blast3d.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "3-D limited AMR blast: conservative + admissible" in out


def test_orszag_tang(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["orszag_tang.py"])
    run_example("orszag_tang.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "orszag-tang: finite + conservative" in out


def test_tree_refinement(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["tree_refinement.py"])
    run_example("tree_refinement.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "tracked + conserved with one compile" in out


def test_raw_sympy_ccode(tmp_path, monkeypatch, capsys):
    run_example("raw_sympy_ccode.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    # Stage 1: the one-statement ccode demo (reference sympy_test.py).
    assert "tmp_x[4*i + j + 16*patch] = X_max_eigenvalues(" in out
    # Stage 2: the full hand-written update (reference full_sympy_test.py)
    # — linearized AoS indices and fmax dissipation straight from ccode.
    assert "Flux(Q_copy[" in out
    assert "fmax(tmp_eig_" in out
    # Stage 3: the DSL emits actual loop nests for the same statements.
    assert "for" in out


def test_limited_blast_walls(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["limited_blast_walls.py", "--cpu"])
    run_example("limited_blast_walls.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "admissible + conservative" in out


def test_limited_shock_production(tmp_path, monkeypatch):
    import sys

    monkeypatch.setattr(sys, "argv", ["limited_shock_production.py", "--cpu"])
    run_example("limited_shock_production.py", tmp_path, monkeypatch)


def test_high_order_p5(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["high_order_p5.py", "--cpu"])
    run_example("high_order_p5.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "high-order p5: accurate + conservative" in out


def test_tracer_vortex(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["tracer_vortex.py", "--cpu"])
    run_example("tracer_vortex.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "ring tracers" in out


def test_seismic_point_source(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["seismic_point_source.py", "--cpu"])
    run_example("seismic_point_source.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "P arrival" in out


def test_seismic_point_source_ck(tmp_path, monkeypatch, capsys):
    """Same demonstrator on the Cauchy–Kovalewski (linear) kernels —
    the class the reference generator emits for seismic PDEs."""
    import sys

    monkeypatch.setattr(
        sys, "argv", ["seismic_point_source.py", "--cpu", "--ck"]
    )
    run_example("seismic_point_source.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "P arrival" in out


def test_rmhd_vortex(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["rmhd_vortex.py", "--cpu"])
    run_example("rmhd_vortex.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "relativistic OT" in out


def test_navier_stokes_vortex(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["navier_stokes_vortex.py", "--cpu"])
    run_example("navier_stokes_vortex.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "KE decay rate" in out


def test_grmhd_curved_blast(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["grmhd_curved_blast.py", "--cpu"])
    run_example("grmhd_curved_blast.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "limited GRMHD-CFC blast" in out


def test_schwarzschild_atmosphere(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["schwarzschild_atmosphere.py", "--cpu"])
    run_example("schwarzschild_atmosphere.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "convergence rate" in out


def test_viscous_shock(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["viscous_shock.py", "--cpu"])
    run_example("viscous_shock.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "viscosity acted" in out


def test_z4_gauge_wave(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["z4_gauge_wave.py", "--cpu"])
    run_example("z4_gauge_wave.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "Z4 gauge wave" in out


def test_tov_star_cowling(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "argv", ["tov_star.py", "--cpu", "--cells", "4"])
    run_example("tov_star.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "held stationary" in out


@pytest.mark.slow
def test_tov_star_coupled(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(
        sys, "argv", ["tov_star.py", "--cpu", "--coupled", "--cells", "4"]
    )
    run_example("tov_star.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "held stationary" in out


def test_seismic3d_layered(tmp_path, monkeypatch, capsys):
    """The 3-D ExaSeis shape: layered heterogeneous medium on CK kernels,
    free surface, sponge edges, point source, surface receivers."""
    import sys

    monkeypatch.setattr(sys, "argv", ["seismic3d_layered.py", "--cpu"])
    run_example("seismic3d_layered.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "materials frozen" in out


def test_seismic_topography(tmp_path, monkeypatch, capsys):
    """Curvilinear seismic: hill-deformed mesh on CK kernels — flat limit
    matches the Cartesian solver, topography measurably deflects the
    seismograms."""
    import sys

    monkeypatch.setattr(sys, "argv", ["seismic_topography.py", "--cpu"])
    run_example("seismic_topography.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "OK" in out and "flat limit" in out


def test_euler_topography(tmp_path, monkeypatch, capsys):
    """Nonlinear curvilinear (round 5): compressible Euler over an
    exactly-periodic terrain dome on Kopriva curl-form metrics — free
    stream at rounding, pulse run conservative."""
    import sys

    monkeypatch.setattr(sys, "argv", ["euler_topography.py", "--cpu"])
    run_example("euler_topography.py", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "nonlinear curvilinear OK" in out
