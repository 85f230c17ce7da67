"""Serving: the batched prefill + decode engine the scheduler dispatches."""
