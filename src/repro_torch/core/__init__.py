"""Macro model, PRNG, quantizers and deploy pass of the port."""
