"""The JAX package's example scripts, ported (``examples/*.py`` there).

Each runs as ``python -m repro_torch.examples.<name>`` with its
counterpart's arguments, defaults, printed lines and closing assertion, and
splits its ``main`` so that a caller can run the body at its own sizes:

  quickstart        the region API of the paging core (``repro_torch.core``)
  out_of_core_sort  the paper's umapsort through a region, mmap-like against
                    UMap's large pages (host only)
  serve_paged       ``ServeEngine`` on the smollm smoke config, checked
                    against unbatched contiguous decode
  train_smollm      ``Trainer`` on a token shard streamed through a UMap
                    region, with async checkpoints and resume

``serve_paged`` and ``train_smollm`` run on the card by default and raise
without one; ``--device cpu`` runs the plain PyTorch path.
"""
