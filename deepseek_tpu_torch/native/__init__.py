"""Native (C++/OpenMP) host code, loaded with ctypes: the port's copies of
``deepseek_tpu/native/`` (the K-quant encoder of the converter and the trie
tokenizer). ``build.py`` compiles each source with g++ at first use into
``build/native/``; ``DSEEK_NO_NATIVE=1`` forces the Python paths.
Importing this package builds nothing."""
