"""Dense decoder of the port."""
