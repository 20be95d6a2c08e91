"""The plain reference that decides ``correct``: plain PyTorch on the
matrices the benchmark made, importing nothing of the program (neither
``chase_tpu_torch`` nor ``jax`` nor ``chase_tpu``).  ``compare`` holds the
comparisons; ``judges/<judge>.py``, named by a configuration's ``judge``,
states ``numbers(H, lam, V, nev, exact, cfg, norm)``, the ones its solves
are held to; ``<family>.py`` states ``exact(inputs)``, a family's exact
spectrum worked out from the family's inputs (None where it has none)."""
