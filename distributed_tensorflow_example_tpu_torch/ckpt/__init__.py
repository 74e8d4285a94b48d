"""The reference's npz parameter format: flat keys, per-array CRC32,
bf16 stored as uint16 views."""
