"""Batched datagen over many independent worlds (``datagen``) and its
on-device frame codec (``codec``)."""
