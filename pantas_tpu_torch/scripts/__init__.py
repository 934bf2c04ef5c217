"""The port's copies of the scale drivers under ``scripts/``, each run as
``python -m pantas_tpu_torch.scripts.<name>``. Nothing is imported here."""
