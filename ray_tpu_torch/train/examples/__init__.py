"""Example training loops of the port."""
