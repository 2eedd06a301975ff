"""Loop-bounds tests.

The 'golden' policy expectations are transcribed from the reference's golden
generated kernel (``Unit test/test.cpp:11-103``): ten loop nests with exactly
these ranges for the dim=2, patch=4, halo=1, n_real=5, n_aux=5 configuration.
"""

from exahype_jax.frontend.statements import StatementKind
from exahype_jax.models.rusanov import build_rusanov_kernel

# (patch, i, j, var) half-open ranges per loop statement, in order, matching
# Unit test/test.cpp loop nests 1..10.
GOLDEN_RANGES = [
    ((0, 1), (0, 6), (0, 6), (0, 10)),  # Q_copy = Q
    ((0, 1), (1, 5), (0, 6), (0, 1)),   # Flux x
    ((0, 1), (0, 6), (1, 5), (0, 1)),   # Flux y
    ((0, 1), (1, 5), (0, 6), (0, 1)),   # maxEigenvalue x
    ((0, 1), (0, 6), (1, 5), (0, 1)),   # maxEigenvalue y
    ((0, 1), (1, 5), (0, 6), (0, 5)),   # flux-difference x
    ((0, 1), (0, 6), (1, 5), (0, 5)),   # flux-difference y
    ((0, 1), (1, 5), (0, 6), (0, 1)),   # Rusanov x
    ((0, 1), (0, 6), (1, 5), (0, 1)),   # Rusanov y
    ((0, 1), (1, 5), (1, 5), (0, 10)),  # Q = Q_copy (interior write-back)
]


def test_golden_policy_matches_reference_unit_test_kernel():
    kb = build_rusanov_kernel()
    loops = [s for s in kb.statements if s.kind is StatementKind.LOOP]
    assert len(loops) == len(GOLDEN_RANGES)
    for stmt, expected in zip(loops, GOLDEN_RANGES):
        assert kb.loop_ranges(stmt, policy="golden") == expected, str(stmt.lhs)


def test_golden_policy_3d():
    kb = build_rusanov_kernel(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0)
    loops = [s for s in kb.statements if s.kind is StatementKind.LOOP]
    # copy: full everywhere, all 5 vars
    assert kb.loop_ranges(loops[0], policy="golden") == (
        (0, 1), (0, 6), (0, 6), (0, 6), (0, 5)
    )
    # Flux z (direction 3): trimmed k only
    flux_z = loops[3]
    assert flux_z.direction == 3
    assert kb.loop_ranges(flux_z, policy="golden") == (
        (0, 1), (0, 6), (0, 6), (1, 5), (0, 1)
    )
    # write-back: trimmed everywhere
    assert kb.loop_ranges(loops[-1], policy="golden") == (
        (0, 1), (1, 5), (1, 5), (1, 5), (0, 5)
    )


def test_sound_policy_reads_are_all_written():
    """Under 'sound', flux/eig evaluations cover the full extent, so the
    stencil updates' shifted reads never touch unwritten elements."""
    kb = build_rusanov_kernel()
    loops = [s for s in kb.statements if s.kind is StatementKind.LOOP]
    flux_x = loops[1]
    # Pointwise directional evaluation: full on every spatial axis.
    assert kb.loop_ranges(flux_x, policy="sound") == ((0, 1), (0, 6), (0, 6), (0, 1))
    # Stencil update: swept axis trimmed, transverse full.
    fluxdiff_x = loops[5]
    assert kb.loop_ranges(fluxdiff_x, policy="sound") == (
        (0, 1), (1, 5), (0, 6), (0, 5)
    )
    # Write-back: interior only.
    assert kb.loop_ranges(loops[-1], policy="sound") == ((0, 1), (1, 5), (1, 5), (0, 10))


def test_cpp_policy_differs_as_documented():
    """The drifted CPPPrinter trims non-directional statements (copy)."""
    kb = build_rusanov_kernel()
    loops = [s for s in kb.statements if s.kind is StatementKind.LOOP]
    copy = loops[0]
    assert kb.loop_ranges(copy, policy="cpp") == ((0, 1), (1, 5), (1, 5), (0, 10))
    # Directional flux sweep without stencil offsets keeps the swept axis full.
    flux_x = loops[1]
    assert kb.loop_ranges(flux_x, policy="cpp") == ((0, 1), (0, 6), (1, 5), (0, 1))
    # Flux-difference sweep has offsets -> swept axis trimmed.
    fluxdiff_x = loops[5]
    assert kb.loop_ranges(fluxdiff_x, policy="cpp") == ((0, 1), (1, 5), (1, 5), (0, 5))
