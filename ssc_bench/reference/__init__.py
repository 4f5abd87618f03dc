"""The plain references the benchmark holds the program against, one
module a model family (``model.py``: StereoScene), with what they share
(``precision.py``, ``train.py``): plain torch, float32, importing nothing
of the program."""
