"""Copies of the pieces of ``repro.core`` that the port's driver needs."""
