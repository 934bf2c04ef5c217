"""PSI / ΔPSI quantification across replicates and conditions."""

from pantas_tpu_torch.quant.quantify import quantify  # noqa: F401
