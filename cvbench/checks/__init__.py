"""The comparisons that decide ``correct``, one module per model: each holds
``reference_outputs`` (the plain reference's answers, in the program's
format, optionally through a fake quantizer: the control) and ``compare``
(the numbers compared with their limits)."""
