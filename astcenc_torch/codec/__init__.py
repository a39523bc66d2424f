"""Codec layer: trial search, driver, physical block codec, decoder."""
