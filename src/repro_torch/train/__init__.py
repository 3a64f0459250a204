"""Training, as ``repro.train``: the generic step factory (``step``), the
BNN trainer and its data-parallel step (``bnn_trainer``), and the
resilient, elastic BNN trainer (``resilience``)."""
