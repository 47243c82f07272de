"""Batched datagen over many independent worlds (``datagen`` for the
cloth, ``datagen_granular`` for granular piles with per-world materials), its
on-device frame codec (``codec``), and the multi-device paths over a mesh
of torch devices held by one process: the rows- and worlds-sharded cloth
(``mesh``) and the grain-sharded granular pile (``granular_mesh``)."""

from . import codec, datagen, datagen_granular, granular_mesh, mesh

__all__ = ["codec", "datagen", "datagen_granular", "granular_mesh", "mesh"]
