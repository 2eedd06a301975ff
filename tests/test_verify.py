"""Uninitialized-read analysis tests.

The analysis must flag exactly the reference's latent bug — the golden
policy's flux-halo reads — and report the canonical kernel clean under the
sound policy.
"""

from exahype_jax.frontend.verify import check_initialized_reads
from exahype_jax.models.rusanov import build_rusanov_kernel


def test_sound_policy_is_clean():
    kb = build_rusanov_kernel()
    assert check_initialized_reads(kb, policy="sound") == []


def test_golden_policy_reproduces_reference_bug():
    """Under golden bounds, the flux-difference statements read tmp_flux
    rows the trimmed flux evaluation never wrote — the uninitialized-heap
    reads baked into the reference's Unit-test kernel."""
    kb = build_rusanov_kernel()
    findings = check_initialized_reads(kb, policy="golden")
    assert findings, "expected uninitialized reads under the golden policy"
    flagged_items = {f.item for f in findings}
    assert any(item.startswith("tmp_flux") for item in flagged_items)
    text = "\n".join(str(f) for f in findings)
    assert "reads tmp_flux" in text and "written [1,5)" in text


def test_assume_zeroed_silences():
    kb = build_rusanov_kernel()
    assert check_initialized_reads(kb, policy="golden", assume_zeroed=True) == []
