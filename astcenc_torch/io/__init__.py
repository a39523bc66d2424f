"""Container and image file I/O (.astc, KTX, DDS, EXR, HDR; PNG/TGA/BMP
through Pillow where it is installed)."""
