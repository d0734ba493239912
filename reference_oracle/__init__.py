"""Float64 NumPy oracle: the in-repo parity baseline for the JAX build.

See fasta_numpy.py for provenance — the upstream reference mount was empty,
so this package IS the algorithm spec (SURVEY.md §0, §7 step 0).
"""

from reference_oracle.fasta_numpy import fasta, FastaResult, STOP_RULES
from reference_oracle import generators

__all__ = ["fasta", "FastaResult", "STOP_RULES", "generators"]
