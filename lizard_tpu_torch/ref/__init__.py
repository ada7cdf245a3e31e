"""Host-side reference code of the port (lizard_tpu/ref counterparts). So far
only the Huff0 header side (`huf`), which the entropy decode plan needs."""
