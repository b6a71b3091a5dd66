"""Command-line tools of the port (counterparts of the root ``tools/``
scripts), each runnable with ``python -m mmgclip_tpu_torch.tools.<name>``."""
