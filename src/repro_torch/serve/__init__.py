"""Serving engines (static-batch path of ``repro.serve``)."""
