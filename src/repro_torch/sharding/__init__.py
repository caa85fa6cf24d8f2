"""Meshes over ``torch.distributed``: the installed mesh, axis rules,
collectives."""
