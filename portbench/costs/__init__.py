"""Frozen arithmetic: analytic operations and minimal bytes of kernels and
model steps, computed from shapes, and the data-sheet peaks they are
priced at.  Later changes to the program do not change these."""
