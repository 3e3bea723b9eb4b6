"""The port's serving surface: the OpenAI-compatible HTTP server (``openai``)."""
