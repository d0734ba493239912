"""Doc-coherence guard for RETRACTED performance figures.

Round-2 retracted the ">roofline" standalone-gradmap record
(0.41 ms/eval, "3.2x the two-pass"): it implied 1.25 TB/s = 153% of the
HBM roofline of the chip then in use, a measurement artifact of an
independent-eval chain.
The retraction was applied to the perf records and README in round 2
but missed two docstrings until round 4 (VERDICT r3 weak #3) — a
half-landed retraction is worse than none, because a reader of the
kernel source walks away with a physically impossible number.

This test greps every tracked doc/source file for the retracted figures
and requires RETRACTION CONTEXT (the word "retract", the "153%"
roofline-violation explanation, or "artifact") within a few lines of
any occurrence, so a future retraction cannot half-land again.
"""

import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# The retracted record's signature strings.  "3.2x"/"3.2×" alone is too
# ambiguous, so the multiplier only counts when the same line also
# names the gradmap/one-pass context it was retracted from.
_RETRACTED_EXACT = ("0.41 ms",)
# 970x / 743x / 800x-of-25.8s: the TV oracle ratios computed against
# the UNPINNED 25.8 s denominator (retired round 5 — the pinned wall
# is 21.275 s, giving ~800x / ~613x for the same kernel walls)
_RETRACTED_PAIRED = re.compile(
    r"3\.2[x×].*(gradmap|one-pass|one-read|two-pass)"
    r"|(gradmap|one-pass|one-read|two-pass).*3\.2[x×]"
    r"|(970|743)[x×].*oracle|oracle.*(970|743)[x×]")
_CONTEXT = re.compile(r"retract|153%|artifact", re.IGNORECASE)
_WINDOW = 3            # lines of surrounding context that may carry it

def _tracked_text_files():
    for pattern in ("*.md", "docs/*.md", "fasta_tpu/**/*.py",
                    "problems/*.py"):
        yield from REPO.glob(pattern)


def _violations(path):
    lines = path.read_text(errors="replace").splitlines()
    bad = []
    for i, line in enumerate(lines):
        hit = any(s in line for s in _RETRACTED_EXACT) \
            or _RETRACTED_PAIRED.search(line)
        if not hit:
            continue
        lo = max(0, i - _WINDOW)
        ctx = "\n".join(lines[lo:i + _WINDOW + 1])
        if not _CONTEXT.search(ctx):
            bad.append(f"{path.relative_to(REPO)}:{i + 1}: {line.strip()}")
    return bad


def test_retracted_figures_only_appear_with_retraction_context():
    bad = []
    for p in _tracked_text_files():
        bad += _violations(p)
    assert not bad, (
        "retracted perf figures published without retraction context "
        "(add the retraction note or purge the number):\n"
        + "\n".join(bad))


# ---------------------------------------------------------------------
# Orphaned oracle denominators (round-4 VERDICT weak #2): every
# "<N> s" oracle wall quoted next to a speedup must be one of the
# PINNED walls from BASELINE.md's measured table (lines ~46-53).
# Round 2 mixed denominators once (25.8 s vs the pinned 21.275 s —
# a 21% ratio inflation); this grep makes that structurally
# impossible to repeat.

_PINNED_ORACLE_WALLS = {
    "21.275",   # TV 512x512 to tol=1e-5
    "1.373",    # phase retrieval 16384x256 to 1e-6
    "0.014",    # LASSO 1000x2000 to 1e-6
    "0.008",    # NNLS to 1e-6
    "0.058",    # sparse logistic to 1e-6
    "0.0156",   # LASSO wall-to-1e-8
}
_ORACLE_WALL = re.compile(r"oracle[^.\n]{0,60}?(\d+(?:\.\d+)?)\s*s\b")


def test_oracle_denominators_are_pinned():
    bad = []
    for p in _tracked_text_files():
        lines = p.read_text(errors="replace").splitlines()
        for i, line in enumerate(lines):
            for m in _ORACLE_WALL.finditer(line):
                if m.group(1) in _PINNED_ORACLE_WALLS:
                    continue
                lo = max(0, i - _WINDOW)
                ctx = "\n".join(lines[lo:i + _WINDOW + 1])
                if _CONTEXT.search(ctx) or "unpinned" in ctx:
                    continue
                bad.append(f"{p.relative_to(REPO)}:{i + 1}: "
                           f"'{m.group(1)} s' — {line.strip()}")
    assert not bad, (
        "oracle wall quoted that is not in BASELINE.md's pinned table "
        "(recompute the ratio against the pinned wall, or re-pin with "
        "a named protocol):\n" + "\n".join(bad))
