"""Physical constants of the dimensionless superlattice model.

The reference defines d, hbar, PI, Me, Kb, Delta_nu (reference:
src/constants.h:4-21) but only PI is actually used by solver code — the
model is fully non-dimensionalized.  We keep the same set for parity.
"""

# superlattice period (unused by solver math; kept for parity)
D = 1.37812249052833

HBAR = 1.0

# The reference's PI literal (src/constants.h:8) — a double slightly off
# from true pi in the last bits; using math.pi would change float64 paths.
PI = 3.141592653589793115998

ME = 1.0
KB = 1.0
DELTA_NU = 1.0
