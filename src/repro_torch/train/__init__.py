"""Serving steps of the port's LM stack (training is not ported yet)."""
