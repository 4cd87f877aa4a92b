"""Gradio web UI (parity with reference `webui.py:29-269`).

Port of `sparktts_tpu/webui.py`.  Two tabs: Voice Clone (upload/mic prompt
audio) and Voice Creation (gender + pitch/speed sliders 1-5 via
LEVELS_MAP_UI).  gradio is optional and imported inside `build_ui`; the
module degrades to a clear error message when it is absent.  The model runs
on $SPARKTTS_PLATFORM's device, else the card (`utils/platform.py`); without
a checkpoint directory, the random-init tiny config.
"""

from __future__ import annotations

import argparse
import logging
from datetime import datetime
from pathlib import Path

from sparktts_tpu_torch.utils.tokens import LEVELS_MAP_UI

logger = logging.getLogger(__name__)


def initialize_model(model_dir=None, max_new_tokens: int = 3000, device=None):
    from sparktts_tpu_torch.cli import load_pipeline

    logger.info("initializing model (dir=%s)", model_dir)
    return load_pipeline(model_dir, max_new_tokens, device)


def run_tts(
    model,
    text: str,
    prompt_text=None,
    prompt_speech=None,
    gender=None,
    pitch=None,
    speed=None,
    save_dir: str = "example/results",
):
    """Synthesize and save a timestamped wav (reference `webui.py:51-92`)."""
    from sparktts_tpu_torch.io.audio import write_wav

    Path(save_dir).mkdir(parents=True, exist_ok=True)
    save_path = Path(save_dir) / f"{datetime.now().strftime('%Y%m%d%H%M%S')}.wav"
    wav = model.inference(
        text,
        prompt_speech_path=prompt_speech,
        prompt_text=prompt_text if prompt_text and len(prompt_text) >= 2 else None,
        gender=gender,
        pitch=pitch,
        speed=speed,
    )
    write_wav(save_path, wav, model.sample_rate)
    return str(save_path)


def build_ui(model_dir=None, max_new_tokens: int = 3000, device=None):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; use `python -m "
            "sparktts_tpu_torch.cli` or the HTTP server (`sparktts_tpu_torch.serve.server`) "
            "instead"
        ) from e

    model = initialize_model(model_dir, max_new_tokens, device)

    def voice_clone(text, prompt_text, prompt_wav_upload, prompt_wav_record):
        prompt_speech = prompt_wav_upload if prompt_wav_upload else prompt_wav_record
        return run_tts(model, text, prompt_text=prompt_text, prompt_speech=prompt_speech)

    def voice_creation(text, gender, pitch, speed):
        return run_tts(
            model,
            text,
            gender=gender,
            pitch=LEVELS_MAP_UI[int(pitch)],
            speed=LEVELS_MAP_UI[int(speed)],
        )

    with gr.Blocks() as demo:
        gr.HTML('<h1 style="text-align: center;">Spark-TTS (CUDA)</h1>')
        with gr.Tabs():
            with gr.TabItem("Voice Clone"):
                with gr.Row():
                    prompt_wav_upload = gr.Audio(
                        sources="upload", type="filepath", label="Reference audio (>5s)"
                    )
                    prompt_wav_record = gr.Audio(
                        sources="microphone", type="filepath", label="Record (>5s)"
                    )
                with gr.Row():
                    text_input = gr.Textbox(label="Text", lines=3)
                    prompt_text_input = gr.Textbox(label="Text of prompt speech (optional)", lines=3)
                audio_output = gr.Audio(label="Generated Audio", autoplay=True)
                gr.Button("Generate").click(
                    voice_clone,
                    inputs=[text_input, prompt_text_input, prompt_wav_upload, prompt_wav_record],
                    outputs=[audio_output],
                )
            with gr.TabItem("Voice Creation"):
                with gr.Row():
                    gender = gr.Radio(choices=["male", "female"], value="male", label="Gender")
                    pitch = gr.Slider(minimum=1, maximum=5, step=1, value=3, label="Pitch")
                    speed = gr.Slider(minimum=1, maximum=5, step=1, value=3, label="Speed")
                text_input_creation = gr.Textbox(label="Input Text", lines=3)
                audio_output_creation = gr.Audio(label="Generated Audio", autoplay=True)
                gr.Button("Create Voice").click(
                    voice_creation,
                    inputs=[text_input_creation, gender, pitch, speed],
                    outputs=[audio_output_creation],
                )
    return demo


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, default=None)
    parser.add_argument("--server_name", type=str, default="0.0.0.0")
    parser.add_argument("--server_port", type=int, default=7860)
    parser.add_argument("--device", choices=["cpu", "cuda"], default=None,
                        help="torch device (default: $SPARKTTS_PLATFORM, else cuda)")
    args = parser.parse_args()
    demo = build_ui(args.model_dir, device=args.device)
    demo.launch(server_name=args.server_name, server_port=args.server_port)


if __name__ == "__main__":
    main()
