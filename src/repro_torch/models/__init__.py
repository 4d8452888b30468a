"""Neural architecture substrate: transformer, MoE, recurrent blocks, LM
serving heads."""
