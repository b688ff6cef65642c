"""Published peak of the card (NVIDIA H100 SXM data sheet, at its full
700 W power limit): HBM bandwidth, bytes per second."""

HBM_BYTES_PER_S = 3.35e12
