"""OpenAI-compatible HTTP server over the port's engine (aiohttp, pydantic)."""
