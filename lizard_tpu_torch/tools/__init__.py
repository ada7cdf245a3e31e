"""Command-line tools of the port (the counterparts of lizard_tpu/tools):
datagen_cli (tests/datagencli.c) and fullbench (tests/fullbench.c)."""
