"""The four examples of ``examples/`` on the port, one module each, with the
same file names: ``python -m repro_torch.examples.<name>`` runs one on the
card (``--device cpu`` runs it on the CPU), and ``main(argv)`` runs it in
process. Each prints the reference example's lines in its format."""
