"""Inputs of the benchmark: a frozen copy of the port's synthetic network
generator (`network`), so that a later change to the program cannot change
what is measured."""
