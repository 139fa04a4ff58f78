"""The paper's evaluation: the FD proxy (fidelity, Fig. 4), the
cross-client inversion attack (Fig. 8) and attribute inference (Fig. 7)."""
