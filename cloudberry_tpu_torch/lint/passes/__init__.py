"""graftlint passes — one module per rule family (locks, tracepurity,
taxonomy, seams). Each exposes ``run(modules, cfg, ...) -> [Finding]``."""
