"""The LLM family: decoder, CLIP tower, Video-ChatGPT and the video-prefix LM."""
