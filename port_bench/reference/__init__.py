"""The plain reference that decides `correct`: the IMPALA agent, V-trace,
the three losses and RMSProp, written out in float32 PyTorch from the
paper's equations and the configuration file's widths.

It imports nothing of the program (`scalable_agent_tpu_torch`) and
nothing of the JAX package. It reads only what the benchmark hands it:
the weights the benchmark made from the seed, the configuration file,
and the program's outputs, which it judges.
"""
