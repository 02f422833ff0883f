"""Score hypothesis vs reference RTTMs: DER / false alarm / confusion /
missed detection (counterpart of the JAX package's
``tools/eval_speaker_diarization/compute_metrics.py``; the port's
``infer_utils/der.py`` in place of pyannote).

Run: python -m voiceprintrecognition_paddlepaddle_torch.eval_speaker_diarization.compute_metrics
[--references=dataset/references.rttm] [--hypotheses=dataset/hypotheses.rttm]
"""

import argparse

from ..infer_utils.der import diarization_error_rate, load_rttm


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--references", default="dataset/references.rttm",
                        help="reference RTTM")
    parser.add_argument("--hypotheses", default="dataset/hypotheses.rttm",
                        help="hypothesis RTTM")
    args = parser.parse_args(argv)

    references = load_rttm(args.references)
    hypotheses = load_rttm(args.hypotheses)
    false_alarms, confusions, missed, error_rates = [], [], [], []
    for uri, reference in references.items():
        hypothesis = hypotheses.get(uri, [])
        result = diarization_error_rate(reference, hypothesis, detailed=True)
        print(uri, ":", result)
        false_alarms.append(result["false alarm"])
        confusions.append(result["confusion"])
        missed.append(result["missed detection"])
        error_rates.append(result["diarization error rate"])

    out = {"false alarm": sum(false_alarms) / len(false_alarms),
           "confusion": sum(confusions) / len(confusions),
           "missed detection": sum(missed) / len(missed),
           "diarization error rate": sum(error_rates) / len(error_rates)}
    print("False alarm:", round(out["false alarm"], 5))
    print("Confusion:", round(out["confusion"], 5))
    print("Missed detection:", round(out["missed detection"], 5))
    print("Diarization error rate:",
          round(out["diarization error rate"], 5))
    return out


if __name__ == "__main__":
    main()
