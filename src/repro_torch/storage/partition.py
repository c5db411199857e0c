"""The padding sentinel shared by every slabbed edge array of the port."""

# THE padding sentinel for ELL / frontier slabs. Kernels and engines test
# ``index < 0``; real vertex ids are never negative, so edges *into
# vertex 0* are always distinguishable from padding.
PAD_SENTINEL = -1
