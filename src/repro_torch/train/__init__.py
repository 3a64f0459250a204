"""Training, as ``repro.train``: the generic step factory (``step``) and
the BNN trainer (``bnn_trainer``)."""
