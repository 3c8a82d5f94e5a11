"""Estimators: the predict half of every checkpoint kind (see ``checkpoint``)."""
