"""Command-line apps (reference Examples/, CMakeLists.txt:104-108)."""
