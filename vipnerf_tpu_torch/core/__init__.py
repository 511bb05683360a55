"""Math of the ViP-NeRF pipeline as plain functions on tensors.

encoding / rays / rendering / sampling take and return torch tensors on any
device; poses is host-side numpy (per-scene set-up, a few 4x4 matrices).
"""
