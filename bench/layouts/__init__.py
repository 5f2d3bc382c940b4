"""One module per layout: ``bench/layouts/<layout>.py``, found by the
``layout`` key of a configuration's stage (``bench/spec.py::layout``)."""
