"""LM iterations a solve: the LM kernel's launches (one a cost, one an
iteration) less the one cost a solve, over the solves."""
SOURCE = "program_counter"


def read(run):
    n = run.counts.get("solves")
    lm = run.launches.get("normal_blocks.launches.lm_step")
    return (lm - n) / n if n and lm else None
