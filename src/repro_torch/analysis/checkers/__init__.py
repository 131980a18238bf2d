"""The stock capslint rules of the port (one module per rule).

Each module exposes one checker class implementing the
:class:`repro_torch.analysis.Checker` protocol; they are registered by
:func:`repro_torch.analysis.default_registry`.
"""
