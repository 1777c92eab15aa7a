"""Model code of the port: the dense decoder-only family (``layers``,
``transformer``) behind one dispatch (``model``)."""
