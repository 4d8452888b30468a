"""Drivers: reconstruction, and the device meshes ranks run on."""
