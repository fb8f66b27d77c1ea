"""Posit number system on torch integer tensors."""
