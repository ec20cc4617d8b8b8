"""The loops that drive a traffic mix, one module each (the traffic file names it)."""
