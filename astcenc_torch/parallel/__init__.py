"""Multi-device encode: the block axis split across torch devices."""
