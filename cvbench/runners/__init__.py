"""Runners: how a traffic mix reaches the program. A mix names its runner
(``"runner"``); each runner's ``run`` does set-up, the window and the
readings the check and the metrics need."""
