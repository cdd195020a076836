"""Losses, LR policies and the optimizer of the port."""
