"""The GroupSharded (ZeRO) stages."""
