"""Run the whole example suite:  python -m problems [--quick]

Prints each problem's three-mode comparison table (the reference's
examples-as-integration-tests idiom, SURVEY.md §4.1) and writes
convergence/solution figures to docs/figures/.
"""

from __future__ import annotations

import os
import sys

from fasta_tpu.harness import compare_modes, format_comparison
from fasta_tpu.plotting import save_comparison_figure

from . import build

QUICK_SIZES = {
    "lasso": dict(m=200, n=400, k=20),
    "nnls": dict(m=200, n=100),
    "logistic": dict(m=200, n=100),
    "tv": dict(h=64, w=64),
    "phase_retrieval": dict(m=1024, n=64),
    "phase_retrieval_cdp": dict(n=64, K=4),
    "democratic": dict(m=64, n=256),
    "mmv": dict(m=100, n=200, l=4, k=10),
    "matrix_completion": dict(d1=60, d2=60, rank=3),
    "max_norm": dict(d1=100, d2=20),
    "svm": dict(m=200, n=50),
    "nmf": dict(d1=40, d2=30, rank=3),
    "sparse_lasso": dict(m=300, n=600, density=0.05),
}


def main():
    quick = "--quick" in sys.argv
    os.makedirs("docs/figures", exist_ok=True)
    for name in QUICK_SIZES:
        kwargs = dict(QUICK_SIZES[name]) if quick else {}
        prob = build(name, **kwargs)
        results = compare_modes(prob, tol=1e-6, max_iters=2000)
        print(format_comparison(prob, results))
        try:
            path = save_comparison_figure(
                prob, results, f"docs/figures/{name}.png")
            print(f"  figure: {path}")
        except Exception as e:          # headless plotting is best-effort
            print(f"  (figure skipped: {e})")
        print()


if __name__ == "__main__":
    main()
