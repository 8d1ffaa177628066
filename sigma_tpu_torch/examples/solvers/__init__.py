"""Solver examples: preconditioned Krylov solves from CSR to pruned storage."""
