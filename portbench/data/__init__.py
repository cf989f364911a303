"""Seeded generators of the cells' data, made on the device."""
