"""Slot-batched serving engine of the port."""
