"""Stdlib and numpy helpers shared by the port's layers."""
